"""Closed-loop Stein MPC on the 2-D particle maze (port of
``sigsvgd_tpu/experiments/maze.py``).

A DuSt controller (the RBF kernel on the policies, or the signature kernel
on the rollouts' XY paths) drives a point mass through an obstacle grid,
optionally inferring the particle's mass online with the MPF after every
real step. Each step's solve, the real step and the termination flags run
on the device; the host fetches one packed tensor a step. With
``checkpoint_dir`` the episode saves its state every ``checkpoint_every``
steps and a restarted episode resumes from the newest checkpoint. With
``mpf_mesh_devices=k`` every rank of a process group of k runs the episode
and the MPF update is sharded over them; ``live_plot`` rewrites a PNG of the
costs while the episode runs.

Run: ``python -m sigsvgd_tpu_torch.experiments.maze --kernel signature --steps 300``
(``--device cpu`` for the CPU; the card by default).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..controllers.dust import NO_DRAWS, DuSt, DuStDraws
from ..inference.likelihoods import GaussianLikelihood
from ..inference.mpf import MPF
from ..inference.svgd import Adam
from ..kernels.rbf import GaussianKernel, ScaledGaussianKernel
from ..kernels.sigkernel import SignatureKernel
from ..models.particle import ParticleModel
from ..utils import distributions as du
from ..utils.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..utils.helper import generate_seeds, save_progress
from ..utils.obstacle_map import get_collisions


@dataclasses.dataclass(frozen=True)
class MazeConfig:
    """The JAX package's defaults (reference ``particle_maze_config.yaml``)."""

    steps: int = 300
    horizon: int = 30
    n_policies: int = 30
    action_samples: int = 10
    params_samples: int = 0
    alpha: float = 1.0
    learning_rate: float = 1.0
    ctrl_sigma: float = 5.0
    opt_steps: int = 2
    kernel: str = "signature"  # rbf | rbf_fixed_bw | signature
    dyadic_order: int = 3
    use_mpf: bool = False
    mpf_n_particles: int = 50
    mpf_steps: int = 20
    mpf_log_space: bool = True
    mpf_learning_rate: float = 0.01
    mpf_bandwidth: float = 0.5
    mpf_obs_std: float = 0.1
    # the MPF update sharded over a process group of this many ranks, each
    # running the episode (parallel.mpf.sharded_mpf_observe)
    mpf_mesh_devices: int = 0
    dyn_prior_mean: float = 2.0
    dyn_prior_std: float = 0.1
    dt: float = 0.015
    warm_up: int = 0
    # save the episode's state every checkpoint_every steps; an episode
    # restarted with the same checkpoint_dir resumes from the newest
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    # per-step cost (and the MPF's mass estimate) streamed to this PNG
    # (utils.live_plot.LiveFigure; needs matplotlib)
    live_plot: Optional[str] = None


class MazeDraws(NamedTuple):
    """Draws given to :func:`run_episode` in place of its generator's."""

    pol_mean: Optional[torch.Tensor] = None  # [n_policies, H, 2] initial policies
    mpf_init: Optional[torch.Tensor] = None  # [mpf_n_particles, 1] N(0, 1)
    steps: Sequence[DuStDraws] = ()  # one a control step

    def to(self, device) -> "MazeDraws":
        def mv(t):
            return None if t is None else t.to(device)

        return MazeDraws(mv(self.pol_mean), mv(self.mpf_init),
                         [DuStDraws(*map(mv, d)) for d in self.steps])


N_PRIM = 5


def make_model(cfg: MazeConfig, device=None) -> ParticleModel:
    return ParticleModel.create(
        dt=cfg.dt,
        control_type="acceleration",
        max_speed=5.0,
        with_obstacle=True,
        obst_preset="sm_grid_4x4",
        obst_width=0.6,
        map_size=(4, 4),
        map_cell_size=0.01,
        # the reference config's start (-1.8, -1.8) lies on the corner
        # obstacle's extent; the JAX package starts just inside the corridor
        init_state=(-1.85, -1.85, 0.0, 0.0),
        target_state=(1.85, 1.85, 0.0, 0.0),
        can_crash=True,
        deterministic=True,
        cost_params={
            "w_qpos": 0.5,
            "w_qvel": 0.25,
            "w_ctrl": 0.2,
            "w_obs": 1.0e6,
            "w_qpos_T": 1.0e3,
            "w_qvel_T": 0.1,
        },
        uncertain_params=("mass",),
        device=device,
    )


def action_primitives(horizon: int, device=None) -> torch.Tensor:
    """The reference's 5 hand-coded primitives: rest and the four diagonals."""
    prims = torch.zeros((N_PRIM, horizon, 2), device=resolve_device(device))
    prims[1] = -10.0
    prims[2] = 10.0
    prims[3] = torch.tensor([-10.0, 10.0])
    prims[4] = torch.tensor([10.0, -10.0])
    return prims


def build_controller(cfg: MazeConfig, model: ParticleModel) -> DuSt:
    """DuSt on ``model``'s device: ``rbf`` (median bandwidth) and
    ``rbf_fixed_bw`` on the policies, ``signature`` on the XY paths at
    dyadic order ``dyadic_order`` with the fixed bandwidth √(2 + H)."""
    fixed_bw = (2 + cfg.horizon) ** 0.5
    if cfg.kernel == "rbf":
        kernel_mode, kernel = "policy", ScaledGaussianKernel()
    elif cfg.kernel == "rbf_fixed_bw":
        kernel_mode = "policy"
        kernel = ScaledGaussianKernel(bandwidth_fn=lambda _: fixed_bw)
    elif cfg.kernel == "signature":
        kernel_mode, kernel = "signature", ScaledGaussianKernel()
    else:
        raise ValueError(f"invalid kernel: {cfg.kernel}")
    return DuSt(
        model=model,
        hz_len=cfg.horizon,
        n_pol=cfg.n_policies,
        device=model.device,
        n_prim=N_PRIM,
        n_action_samples=cfg.action_samples,
        n_params_samples=cfg.params_samples,
        pol_cov=tuple(map(tuple, (np.eye(2) * cfg.ctrl_sigma**2).tolist())),
        temperature=cfg.alpha,
        params_log_space=cfg.mpf_log_space,
        kernel_mode=kernel_mode,
        kernel=kernel,
        sig_kernel=SignatureKernel(dyadic_order=cfg.dyadic_order, bandwidth=fixed_bw),
        optimizer=Adam(cfg.learning_rate),
        inst_cost_fn=model.default_inst_cost,
        term_cost_fn=model.default_term_cost,
    )


def build_mpf(cfg: MazeConfig, model: ParticleModel) -> MPF:
    """The MPF over the particle's mass: a Gaussian observation model on
    ``model``'s step (in log space with ``mpf_log_space``) and the Gaussian
    kernel at the fixed bandwidth ``mpf_bandwidth``."""
    lik = GaussianLikelihood(step_fn=model.step, params_to_dict=model.params_to_dict,
                             obs_std=cfg.mpf_obs_std, log_space=cfg.mpf_log_space)
    return MPF(likelihood=lik, kernel=GaussianKernel(), lr=cfg.mpf_learning_rate,
               bw=cfg.mpf_bandwidth)


def sample_draws(cfg: MazeConfig, generator: torch.Generator) -> MazeDraws:
    """Every draw of a ``cfg.steps``-step episode, from ``generator`` on its
    device, so that one episode can run alike on two devices."""
    dev = generator.device
    ctrl = build_controller(cfg, make_model(cfg, dev))
    pol = ctrl.init(generator=generator,
                    action_primitives=action_primitives(cfg.horizon, dev)).pol_mean
    mpf_init = None
    if cfg.use_mpf:
        mpf_init = torch.randn((cfg.mpf_n_particles, 1), generator=generator, device=dev)
    shape = (cfg.opt_steps, cfg.action_samples, cfg.n_policies + N_PRIM, cfg.horizon, 2)
    P, steps = cfg.params_samples, []
    for _ in range(cfg.steps):
        params = comps = None
        if P:
            params = torch.randn((P, 1), generator=generator, device=dev)
            if cfg.use_mpf:
                comps = torch.randint(0, cfg.mpf_n_particles, (P,), generator=generator,
                                      device=dev)
        steps.append(DuStDraws(
            actions=torch.randn(shape, generator=generator, device=dev)
            if cfg.action_samples else None, params=params, params_comps=comps))
    return MazeDraws(pol_mean=pol[N_PRIM:], mpf_init=mpf_init, steps=steps)


def _mpf_mesh(k: int, device: torch.device):
    """The 1-D 'dp' mesh of the sharded MPF update: the process group of
    ``k`` ranks this episode runs on, one episode on each rank."""
    if not dist.is_initialized() or dist.get_world_size() != k:
        raise RuntimeError(
            f"mpf_mesh_devices={k} runs the MPF update sharded over an initialised "
            f"process group of {k} ranks, each running this episode "
            "(torch.distributed.init_process_group, or parallel.init_distributed "
            "under torchrun)")
    from ..parallel.mesh import make_mesh

    return make_mesh([k], ("dp",), device_type=device.type)


def run_episode(cfg: MazeConfig, seed: int, verbose: bool = False, device=None,
                draws: Optional[MazeDraws] = None) -> Dict[str, Any]:
    """One closed-loop episode on ``device`` (None means the card); returns
    the trajectory, actions, costs and, with the MPF, its particles after
    each step. Draws come from a generator on the device seeded with
    ``seed`` (the initial policies, the MPF's initial particles, then each
    step's), or from ``draws``. A checkpoint holds the state, the
    controller's and the MPF's states, the generator's state and the history
    so far, so a resumed episode repeats the uninterrupted one."""
    device = resolve_device(device)
    model = make_model(cfg, device)
    ctrl = build_controller(cfg, model)
    draws = draws or MazeDraws()
    gen = torch.Generator(device=device).manual_seed(seed)
    cstate = ctrl.init(
        pol_mean=None if draws.pol_mean is None else draws.pol_mean.to(device),
        generator=gen, action_primitives=action_primitives(cfg.horizon, device))

    dyn_prior = du.Gaussian(
        mean=torch.tensor([cfg.dyn_prior_mean], device=device),
        cov=torch.tensor([cfg.dyn_prior_std**2], device=device),
    )

    mpf = mpf_state = None
    state = torch.tensor(model.init_state, dtype=torch.float32, device=device)
    if cfg.use_mpf:
        mpf = build_mpf(cfg, model)
        init_particles = du.sample(dyn_prior, (cfg.mpf_n_particles,), gen,
                                   eps=draws.mpf_init).clamp_min(1e-6)
        if cfg.mpf_log_space:
            init_particles = torch.log(init_particles)
        mpf_state = mpf.init(init_particles, state)
    mpf_mesh = _mpf_mesh(cfg.mpf_mesh_devices, device) if mpf and cfg.mpf_mesh_devices else None

    def observe(mpf_state, action, obs):
        if mpf_mesh is None:
            return mpf.observe(mpf_state, action, obs, n_steps=cfg.mpf_steps)[0]
        # each rank moves its rows; every rank keeps all the moved particles
        from ..parallel.mesh import local_rows
        from ..parallel.mpf import sharded_mpf_observe

        local = mpf_state._replace(particles=local_rows(mpf_state.particles, mpf_mesh))
        new, _ = sharded_mpf_observe(mpf, local, action, obs, mpf_mesh,
                                     n_steps=cfg.mpf_steps)
        return new._replace(particles=new.prior_means)

    @torch.no_grad()
    def mpc_step(state, cstate, params_dist, step_draws):
        a_seq, cstate, _ = ctrl.forward(state, cstate, params_dist, gen,
                                           opt_steps=cfg.opt_steps, draws=step_draws)
        action = a_seq[0]
        nxt = model.step(state[None], action[None])[0]
        # the termination flags on the device, fetched with the step
        inst_cost = model.default_inst_cost(nxt[None])[0]
        crashed = get_collisions(model.obstacle_map, nxt[:2]) > 0
        reached = torch.linalg.vector_norm(model.target - nxt) <= 1.0
        return action, nxt, cstate, inst_cost, crashed, reached

    gmm_weights = torch.ones(cfg.mpf_n_particles, device=device)
    states, actions, costs, dyn_particles = [state.cpu().numpy()], [], [], []

    def saved():
        return {"state": state, "cstate": cstate,
                "mpf_state": mpf_state if mpf else torch.zeros(()),
                "generator": gen.get_state()}

    start_step = 0
    latest = latest_checkpoint(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    if latest is not None:
        restored = restore_checkpoint(latest, saved())
        state, cstate = restored["state"], restored["cstate"]
        if mpf:
            mpf_state = restored["mpf_state"]
        gen.set_state(restored["generator"])
        start_step = int(latest.name.split("_")[1])
        hist = np.load(latest / "history.npz")
        states, actions, costs = (list(hist[k]) for k in ("states", "actions", "costs"))
        if hist["dyn_particles"].size:
            dyn_particles = list(hist["dyn_particles"])

    def save(step: int):
        path = Path(cfg.checkpoint_dir) / f"step_{step}"
        save_checkpoint(path, saved())
        np.savez(path / "history.npz", states=np.stack(states),
                 actions=np.stack(actions) if actions else np.zeros((0, 2)),
                 costs=np.asarray(costs),
                 dyn_particles=np.stack(dyn_particles) if dyn_particles else np.zeros(0))

    live = None
    if cfg.live_plot:
        from ..utils.live_plot import LiveFigure

        live = LiveFigure(nrows=2 if mpf else 1, out_path=cfg.live_plot, redraw_every=10)

    reached_goal = crashed = False
    t0 = time.perf_counter()
    step_ends = [t0]
    for step in range(start_step, cfg.steps):
        step_draws = NO_DRAWS
        if draws.steps:
            if step >= len(draws.steps):
                raise ValueError(f"draws given for {len(draws.steps)} steps; "
                                 f"step {step} needs its own")
            step_draws = draws.steps[step]
        params_dist = (
            du.ParticleGMM(means=mpf_state.particles, var=mpf_state.prior_bw**2,
                           weights=gmm_weights)
            if mpf else dyn_prior
        )
        action, state, cstate, inst_cost, hit, arrived = mpc_step(
            state, cstate, params_dist, step_draws)
        observed = mpf is not None and step >= cfg.warm_up
        if observed:
            mpf_state = observe(mpf_state, action, state)
        # one host transfer a step (the MPF's particles folded in)
        packed = [action, state, inst_cost[None], hit[None].float(),
                  arrived[None].float()]
        if observed:
            packed.append(mpf_state.particles.reshape(-1))
        fetched = torch.cat(packed).cpu().numpy()
        step_ends.append(time.perf_counter())
        states.append(fetched[2:6])
        actions.append(fetched[0:2])
        costs.append(float(fetched[6]))
        if observed:
            dyn_particles.append(fetched[9:].reshape(mpf_state.particles.shape))
        if live:
            live.append("inst_cost", fetched[6])
            if observed:
                mean = float(np.mean(fetched[9:]))
                live.append("mass posterior mean",
                            np.exp(mean) if cfg.mpf_log_space else mean, panel=1)
        reached_goal = bool(fetched[8])
        if fetched[7]:
            crashed = True
            if verbose:
                print(f"Crashed at step {step}")
            break
        if reached_goal:
            if verbose:
                print(f"Reached goal at step {step}")
            break
        if cfg.checkpoint_dir and cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
            save(step + 1)
    wall = time.perf_counter() - t0
    if live:
        live.redraw()
        live.close()

    return {
        "trajectory": np.stack(states),
        "actions": np.stack(actions) if actions else np.zeros((0, 2)),
        "costs": np.asarray(costs),
        "dyn_particles": np.stack(dyn_particles) if dyn_particles else None,
        "steps": len(actions),
        "wall_clock_s": wall,
        # each step's wall time: the solve, the MPF update and the fetch
        "step_wall_s": np.diff(step_ends),
        "reached_goal": reached_goal,
        "crashed": crashed,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernel", default="signature",
                        choices=["rbf", "rbf_fixed_bw", "signature"])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--episodes", type=int, default=1)
    parser.add_argument("--use-mpf", action="store_true")
    parser.add_argument("--mpf-mesh-devices", type=int, default=0,
                        help="shard the MPF update over this many ranks (run under "
                             "torchrun with as many processes)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--live-plot", default=None, metavar="PNG",
                        help="rewrite this PNG with the costs while the episode runs "
                             "(needs matplotlib)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.mpf_mesh_devices:
        from ..parallel.distributed import init_distributed

        init_distributed(device_type="cpu" if args.device == "cpu" else None)

    cfg = MazeConfig(
        kernel=args.kernel, steps=args.steps, use_mpf=args.use_mpf,
        mpf_mesh_devices=args.mpf_mesh_devices, live_plot=args.live_plot,
    )
    for ep, seed in enumerate(generate_seeds(args.episodes)):
        result = run_episode(cfg, seed, verbose=True, device=args.device)
        summary = {
            "episode": ep,
            "seed": seed,
            "steps": result["steps"],
            "total_cost": float(result["costs"].sum()),
            "reached_goal": bool(result["reached_goal"]),
            "wall_clock_s": round(result["wall_clock_s"], 2),
        }
        print(json.dumps(summary))
        if args.out:
            save_progress(f"{args.out}/ep{ep}", data=result, config=dataclasses.asdict(cfg))


if __name__ == "__main__":
    main()
