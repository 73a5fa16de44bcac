"""Ranks of the port's sharded tests: a gloo group of CPU processes.

This module imports neither JAX nor the JAX package: ``spawn`` makes each
child import the module that holds its target, and a test file that imports
JAX would import it in every child. A test starts the ranks with
:func:`start_ranks` (a ``FileStore`` under the test's temporary directory
for the rendezvous, no TCP port; one CPU thread a rank), may compute its
JAX references meanwhile, and collects rank 0's results with
:meth:`Ranks.join`, which kills the ranks and raises after ``timeout``
seconds rather than hang on a rendezvous.

A case is ``(name, function name, spec)``: every rank runs the function on
the spec (numpy arrays and plain values) and rank 0's return value is the
case's result. Sharded results are gathered into whole arrays on the ranks.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
import traceback
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

Case = Tuple[str, str, Dict[str, Any]]


# -- spawning ---------------------------------------------------------------

def _worker(rank: int, world: int, store: str, cases: List[Case], out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    results = {}
    try:
        for name, fn, spec in cases:
            try:
                results[name] = globals()[fn](spec)
            except Exception:  # the case's test fails with this traceback
                results[name] = {"error": f"rank {rank}: {traceback.format_exc()}"}
                raise
    finally:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


class Ranks:
    def __init__(self, ctx, out: str, world: int, timeout: float):
        self.ctx, self.out, self.world = ctx, out, world
        self.deadline = time.monotonic() + timeout

    def join(self) -> Dict[str, Any]:
        """Rank 0's results by case name. A case that raised on any rank
        holds ``{"error": traceback}``; the cases after it are missing."""
        timed_out = False
        try:
            while not self.ctx.join(timeout=max(0.1, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    timed_out = True
                    break
        except (mp.ProcessRaisedException, mp.ProcessExitedException):
            pass
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        per_rank = []
        for r in range(self.world):
            if os.path.exists(f"{self.out}.{r}"):
                with open(f"{self.out}.{r}", "rb") as f:
                    per_rank.append(pickle.load(f))
        results = per_rank[0] if per_rank and os.path.exists(f"{self.out}.0") else {}
        for other in per_rank:
            for name, r in other.items():
                if isinstance(r, dict) and "error" in r:
                    results[name] = r
        if timed_out and not results:
            raise TimeoutError("the ranks did not finish in time")
        return results


def start_ranks(world: int, cases: List[Case], tmp_dir, timeout: float = 240.0) -> Ranks:
    """Start ``world`` ranks running ``cases``; returns at once."""
    tmp_dir = str(tmp_dir)
    out = os.path.join(tmp_dir, "results.pkl")
    ctx = mp.start_processes(_worker, args=(world, os.path.join(tmp_dir, "store"), cases,
                                            out),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, out, world, timeout)


def result(results: Dict[str, Any], name: str):
    """A case's result; fails the calling test with the rank's traceback."""
    if name not in results:
        raise AssertionError(f"case {name} did not run (an earlier case failed)")
    r = results[name]
    if isinstance(r, dict) and "error" in r:
        raise AssertionError(f"case {name} failed on rank 0:\n{r['error']}")
    return r


# -- helpers ------------------------------------------------------------------

def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh(spec):
    """The spec's mesh on its device ("cpu" unless ``spec["device"]``; ranks
    share card 0)."""
    from sigsvgd_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(spec.get("mesh", [dist.get_world_size()]),
                     tuple(spec.get("axes", ("dp",))), device_type=spec.get("device", "cpu"))


def _gather_rows(t: torch.Tensor, mesh, axis="dp") -> np.ndarray:
    from sigsvgd_tpu_torch.parallel import comm
    from sigsvgd_tpu_torch.parallel.mesh import axis_group

    return _n(comm.all_gather(t.contiguous(), axis_group(mesh, axis)))


def _tree_map(fn, node):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_tree_map(fn, c) for c in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_tree_map(fn, c) for c in node)
    return fn(node)


def _leaves(node):
    if isinstance(node, tuple):
        return [x for c in node for x in _leaves(c)]
    return [node] if isinstance(node, torch.Tensor) else []


# -- controllers (the JAX tests' configurations) -------------------------------

def build_dust(spec):
    """The port's DuSt on the CPU for ``spec["ctrl"]``: the pendulum
    controllers of ``tests/test_parallel_dust.py``."""
    from sigsvgd_tpu_torch.controllers.dust import DuSt
    from sigsvgd_tpu_torch.inference.svgd import Adam
    from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel
    from sigsvgd_tpu_torch.models.pendulum import PendulumModel

    c = dict(spec["ctrl"])
    model = PendulumModel(dt=0.05)
    bw = c.pop("kernel_bw", "median")
    kernel = GaussianKernel() if bw == "median" else GaussianKernel(
        bandwidth_fn=lambda _: torch.tensor(bw, dtype=torch.float32))
    sig = c.pop("sig", None)
    lr = c.pop("adam", None)
    return DuSt(model=model, device=spec.get("device", "cpu"), kernel=kernel,
                sig_kernel=SignatureKernel(**sig) if sig else SignatureKernel(dyadic_order=2),
                optimizer=Adam(lr) if lr else None,
                inst_cost_fn=model.swingup_inst_cost, term_cost_fn=model.swingup_term_cost,
                **c)


def _params_dist(spec):
    from sigsvgd_tpu_torch.utils import distributions as du

    p = spec.get("params_dist")
    if p is None:
        return None
    return du.Gaussian(mean=torch.tensor(p[0]), cov=torch.tensor(p[1]))


def _local_cstate(cs, n_total: int, mesh):
    from sigsvgd_tpu_torch.parallel.mesh import local_rows

    def rows(t):
        if isinstance(t, torch.Tensor) and t.ndim >= 1 and t.shape[0] == n_total:
            return local_rows(t, mesh)
        return t

    return _tree_map(rows, cs)


def _full_cstate(cs, n_local: int, mesh):
    """Whole arrays of a sharded state's leaves (gathered over 'dp')."""
    out = []
    for t in [cs.pol_mean, cs.prior_weights] + _leaves(cs.svgd_state.opt_state):
        out.append(_gather_rows(t, mesh) if t.ndim >= 1 and t.shape[0] == n_local
                   else _n(t))
    return out


def _flat_cstate(cs):
    return [_n(t) for t in [cs.pol_mean, cs.prior_weights] + _leaves(cs.svgd_state.opt_state)]


def case_dust(spec):
    """Chained sharded solves (``spec["modes"]``: gram modes), and on rank 0
    the single-device solves from the same policies and generator seed."""
    from sigsvgd_tpu_torch.parallel.dust import sharded_dust_forward

    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    mesh = _mesh(spec)
    ctrl = build_dust(spec)
    dev = ctrl.device
    state = torch.tensor(spec["state"], dtype=torch.float32, device=dev)
    pol0 = torch.from_numpy(spec["pol0"]).to(dev)
    prims = spec.get("prims")
    prims = None if prims is None else torch.from_numpy(prims).to(dev)
    pdist = _params_dist(spec)
    out = {"launches": {}}
    for mode in spec.get("modes", ["auto"]):
        cs = ctrl.init(pol_mean=pol0, action_primitives=prims)
        cs = _local_cstate(cs, ctrl.n_total, mesh)
        n_local = cs.pol_mean.shape[0]
        gen = torch.Generator(device=dev).manual_seed(spec.get("seed", 0))
        solves = []
        k0 = (kb.block_gram_and_grad.launches, kb3.block3_gram_and_grad.launches)
        for _ in range(spec.get("solves", 1)):
            a, cs = sharded_dust_forward(ctrl, state, cs, gen, spec["opt_steps"], mesh,
                                         col_axis=spec.get("col_axis"), params_dist=pdist,
                                         gram_mode=mode)
            solves.append([_n(a)] + _full_cstate(cs, n_local, mesh))
        out[mode] = solves
        out["launches"][mode] = (kb.block_gram_and_grad.launches - k0[0],
                                 kb3.block3_gram_and_grad.launches - k0[1])
    if dist.get_rank() == 0 and spec.get("single", True):
        cs = ctrl.init(pol_mean=pol0, action_primitives=prims)
        gen = torch.Generator(device=dev).manual_seed(spec.get("seed", 0))
        solves = []
        for _ in range(spec.get("solves", 1)):
            a, cs, _ = ctrl.forward(state, cs, pdist, gen, opt_steps=spec["opt_steps"])
            solves.append([_n(a)] + _flat_cstate(cs))
        out["single"] = solves
    return out


def case_closed_loop(spec):
    """``make_sharded_mpc_step`` for ``spec["steps"]`` steps, and the
    single-device loop on rank 0."""
    from sigsvgd_tpu_torch.parallel.dust import make_sharded_mpc_step

    mesh = _mesh(spec)
    ctrl = build_dust(spec)
    step = make_sharded_mpc_step(ctrl, mesh, opt_steps=spec["opt_steps"])
    state = torch.tensor(spec["state"], dtype=torch.float32)
    cs = _local_cstate(ctrl.init(pol_mean=torch.from_numpy(spec["pol0"])), ctrl.n_total, mesh)
    states = []
    for _ in range(spec["steps"]):
        state, cs, _ = step(state, cs)
        states.append(_n(state))
    out = {"states": np.stack(states), "step": int(cs.svgd_state.step),
           "pol": _gather_rows(cs.pol_mean, mesh)}
    if dist.get_rank() == 0:
        state = torch.tensor(spec["state"], dtype=torch.float32)
        cs = ctrl.init(pol_mean=torch.from_numpy(spec["pol0"]))
        single = []
        for _ in range(spec["steps"]):
            a, cs, _ = ctrl.forward(state, cs, None, None, opt_steps=spec["opt_steps"])
            state = ctrl.model.step(state[None], a[0:1])[0]
            single.append(_n(state))
        out["single"] = np.stack(single)
    return out


def case_inventory(spec):
    """The collectives of one sharded solve of 2 Adam steps."""
    from sigsvgd_tpu_torch.parallel.dust import sharded_dust_forward
    from sigsvgd_tpu_torch.parallel.scaling import collective_stats

    mesh = _mesh(spec)
    ctrl = build_dust(spec)
    cs = _local_cstate(ctrl.init(pol_mean=torch.from_numpy(spec["pol0"])), ctrl.n_total, mesh)
    state = torch.tensor(spec["state"], dtype=torch.float32)
    return collective_stats(sharded_dust_forward, ctrl, state, cs, None, 2, mesh)


def case_scaling(spec):
    from sigsvgd_tpu_torch.parallel.dust import sharded_dust_forward
    from sigsvgd_tpu_torch.parallel.scaling import measure_scaling

    ctrl = build_dust(spec)
    state = torch.tensor(spec["state"], dtype=torch.float32)

    def make_step(mesh):
        cs = _local_cstate(ctrl.init(pol_mean=torch.from_numpy(spec["pol0"])), ctrl.n_total,
                           mesh)
        return lambda: sharded_dust_forward(ctrl, state, cs, None, 2, mesh)

    return measure_scaling(make_step, (1, 2), n_iters=2, device_type="cpu")


# -- SVGD, the path-signature score, the median, the MPF ------------------------

def _score_quadratic(x, generator=None):
    from sigsvgd_tpu_torch.inference.svgd import ScoreResult

    return ScoreResult(grad_log_p=-x)


def _pathsig_cost(x):
    target = torch.tensor([1.0, 1.0])
    cost = torch.sum((x[:, -1, :] - target) ** 2, dim=-1) + 0.1 * torch.sum(x**2, dim=(1, 2))
    return cost, {}


def case_svgd(spec):
    """``sharded_svgd_run`` (RBF score or the path-signature score) and, on
    rank 0, ``SVGD.run`` from the same particles."""
    from sigsvgd_tpu_torch.inference.score import pathsig_score
    from sigsvgd_tpu_torch.inference.svgd import SVGD, Adam
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel
    from sigsvgd_tpu_torch.parallel.mesh import local_rows
    from sigsvgd_tpu_torch.parallel.svgd import sharded_pathsig_score, sharded_svgd_run

    mesh = _mesh(spec)
    col = spec.get("col_axis")
    x0 = torch.from_numpy(spec["x0"])
    if spec["score"] == "pathsig":
        kern = SignatureKernel(dyadic_order=1, bandwidth=2.0)
        svgd = SVGD(optimizer=None, lr=0.05)
        score = sharded_pathsig_score(_pathsig_cost, kern, mesh, col_axis=col)
        single_score = pathsig_score(_pathsig_cost, kern)
    else:
        svgd = SVGD(optimizer=Adam(0.1) if spec.get("adam") else None, lr=spec.get("lr", 0.01))
        score = single_score = _score_quadratic
    x, losses = sharded_svgd_run(svgd, local_rows(x0, mesh), score, spec["steps"], mesh,
                                 col_axis=col)
    out = {"x": _gather_rows(x, mesh), "losses": _n(losses)}
    if dist.get_rank() == 0:
        out["single"] = _n(svgd.run(x0, single_score, spec["steps"])[0])
    return out


def case_median(spec):
    """``distributed_median`` and ``distributed_median_diff``'s gradient on
    ``vals`` sharded over the mesh's dims (rows over 'dp', columns over 'sp'
    on a 2-D mesh)."""
    from sigsvgd_tpu_torch.parallel.mesh import axis_index, axis_size, local_rows
    from sigsvgd_tpu_torch.parallel.svgd import distributed_median, distributed_median_diff

    mesh = _mesh(spec)
    axes = tuple(spec.get("axes", ("dp",)))
    v = local_rows(torch.from_numpy(spec["vals"]), mesh, "dp")
    if "sp" in axes:
        sp = axis_size(mesh, "sp")
        c = v.shape[1] // sp
        v = v[:, axis_index(mesh, "sp") * c:(axis_index(mesh, "sp") + 1) * c]
    v = v.contiguous().requires_grad_(True)
    med = distributed_median(v.detach(), mesh, axes)
    m2 = distributed_median_diff(v, mesh, axes)
    (g,) = torch.autograd.grad(m2 * 3.0, v)
    grads = [None] * dist.get_world_size()
    dist.all_gather_object(grads, (dist.get_rank(), _n(g)))
    return {"median": _n(med), "median_diff": _n(m2.detach()), "grads": grads}


def _mpf_setup(bw):
    from sigsvgd_tpu_torch.inference.likelihoods import GaussianLikelihood
    from sigsvgd_tpu_torch.inference.mpf import MPF
    from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
    from sigsvgd_tpu_torch.models.particle import ParticleModel

    model = ParticleModel.create(dt=0.1, mass=2.0, control_type="acceleration",
                                 map_size=(10, 10), map_cell_size=0.5, max_speed=50.0,
                                 device="cpu")
    lik = GaussianLikelihood(step_fn=model.step, params_to_dict=model.params_to_dict,
                             obs_std=0.05)
    return model, MPF(likelihood=lik, kernel=GaussianKernel(), lr=0.05, bw=bw)


def case_mpf(spec):
    """One sharded observe-update and, on rank 0, ``MPF.observe``."""
    from sigsvgd_tpu_torch.parallel.mesh import local_rows
    from sigsvgd_tpu_torch.parallel.mpf import sharded_mpf_observe

    mesh = _mesh(spec)
    model, mpf = _mpf_setup(spec["bw"])
    particles = torch.from_numpy(spec["particles"])
    state = torch.zeros(4)
    mstate = mpf.init(particles, state)
    action = torch.tensor([1.0, -0.5])
    nxt = model.step(state[None], action[None])[0]
    local = mstate._replace(particles=local_rows(particles, mesh))
    shard, grads = sharded_mpf_observe(mpf, local, action, nxt, mesh,
                                       n_steps=spec["n_steps"])
    out = {"particles": _gather_rows(shard.particles, mesh), "grads": _n(grads),
           "prior_bw": _n(shard.prior_bw), "prior_means": _n(shard.prior_means)}
    if dist.get_rank() == 0:
        single, g = mpf.observe(mstate, action, nxt, n_steps=spec["n_steps"])
        out["single"] = {"particles": _n(single.particles), "grads": _n(g),
                         "prior_bw": _n(single.prior_bw)}
    return out


def case_maze(spec):
    """The maze episode with its MPF sharded over the group, and on rank 0
    the unsharded episode."""
    from sigsvgd_tpu_torch.experiments import maze

    cfg = maze.MazeConfig(**spec["cfg"])
    sharded = maze.run_episode(dataclasses.replace(cfg, mpf_mesh_devices=dist.get_world_size()),
                               spec["seed"], device="cpu")
    out = {"sharded": {k: sharded[k] for k in ("trajectory", "dyn_particles", "actions")}}
    if dist.get_rank() == 0:
        single = maze.run_episode(cfg, spec["seed"], device="cpu")
        out["single"] = {k: single[k] for k in ("trajectory", "dyn_particles", "actions")}
    return out


def case_global(spec):
    """``init_distributed`` inside a group, ``global_particle_mesh`` and
    ``make_global_particles``: every rank's rows of one draw."""
    from sigsvgd_tpu_torch.parallel.distributed import (
        global_particle_mesh, init_distributed, make_global_particles,
    )

    rank = init_distributed(device_type="cpu")
    mesh = global_particle_mesh(sp=spec.get("sp", 1), device_type="cpu")
    x = make_global_particles(torch.Generator().manual_seed(spec["seed"]), spec["shape"], mesh)
    return {"rank": rank, "mesh": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
            "rows": _gather_rows(x, mesh)}
