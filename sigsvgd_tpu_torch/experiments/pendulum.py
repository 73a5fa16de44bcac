"""Closed-loop pendulum swing-up with DuSt, and the DISCO baseline (port of
``sigsvgd_tpu/experiments/pendulum.py``).

The environment is the model itself: the simulator steps the dynamics with
the true parameters while the controller may plan under sampled ones.

Run: ``python -m sigsvgd_tpu_torch.experiments.pendulum --controller dust``
(``--controller disco``; ``--device cpu`` for the CPU, the card by default).
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from ..controllers.disco import DISCO
from ..controllers.dust import DuSt
from ..inference.svgd import Adam
from ..kernels.rbf import ScaledGaussianKernel
from ..models.pendulum import PendulumModel
from ..utils import distributions as du


def _params_dist(device) -> du.Gaussian:
    return du.Gaussian(mean=torch.tensor([9.8, 1.0, 1.0], device=device),
                       cov=torch.eye(3, device=device) * 0.05)


def _summary(states, wall: float, steps: int) -> Dict:
    traj = torch.stack(states).cpu().numpy()
    theta_wrapped = np.mod(traj[:, 0] + np.pi, 2 * np.pi) - np.pi
    return {
        "trajectory": traj,
        "final_upright_error_rad": float(np.abs(theta_wrapped[-20:]).mean()),
        "wall_clock_s": wall,
        "solves_per_s": steps / wall,
    }


def run_dust(steps: int = 200, horizon: int = 20, n_pol: int = 1,
             n_params_samples: int = 0, opt_steps: int = 5, seed: int = 0,
             device=None) -> Dict:
    """DuSt (policy mode, Adam 0.1) swinging the pendulum up from hanging
    down; its draws from a generator on ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    model = PendulumModel(dt=0.05)
    ctrl = DuSt(
        model=model,
        hz_len=horizon,
        n_pol=n_pol,
        device=device,
        n_action_samples=0,
        n_params_samples=n_params_samples,
        kernel_mode="policy",
        kernel=ScaledGaussianKernel(),
        optimizer=Adam(0.1),
        inst_cost_fn=model.swingup_inst_cost,
        term_cost_fn=model.swingup_term_cost,
    )
    params_dist = _params_dist(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cstate = ctrl.init(generator=gen)
    state = torch.tensor([math.pi, 0.0], device=device)  # hanging down

    states, actions = [state], []
    t0 = time.perf_counter()
    for _ in range(steps):
        a_seq, cstate, _ = ctrl.forward(state, cstate, params_dist, gen,
                                        opt_steps=opt_steps)
        state = model.step(state[None], a_seq[0:1])[0]
        states.append(state)
        actions.append(a_seq[0])
    res = _summary(states, time.perf_counter() - t0, steps)
    res["actions"] = torch.stack(actions).cpu().numpy()
    return res


def run_disco(steps: int = 200, horizon: int = 30, n_actions: int = 256,
              n_pol: int = 1, seed: int = 0, device=None) -> Dict:
    """DISCO with 4 parameter samples a solve (σ = 3 torque noise, a low
    temperature), from hanging down; its draws from a generator on
    ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    model = PendulumModel(dt=0.05)
    ctrl = DISCO(
        model=model,
        hz_len=horizon,
        n_actions=n_actions,
        n_pol=n_pol,
        device=device,
        pol_cov=((9.0,),),
        temperature=0.2,
        ctrl_penalty=1.0,
        n_params=4,
        inst_cost_fn=model.swingup_inst_cost,
        term_cost_fn=model.swingup_term_cost,
    )
    params_dist = _params_dist(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cstate = ctrl.init()
    state = torch.tensor([math.pi, 0.0], device=device)

    states = [state]
    t0 = time.perf_counter()
    for _ in range(steps):
        cstate, _ = ctrl.forward(state, cstate, params_dist, gen)
        action, cstate = ctrl.act(cstate)
        state = model.step(state[None], action)[0]
        states.append(state)
    return _summary(states, time.perf_counter() - t0, steps)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", default="dust", choices=["dust", "disco"])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--n-pol", type=int, default=1)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    run = run_dust if args.controller == "dust" else run_disco
    res = run(steps=args.steps, n_pol=args.n_pol, device=args.device)
    print(json.dumps({
        "controller": args.controller,
        "final_upright_error_rad": round(res["final_upright_error_rad"], 4),
        "solves_per_s": round(res["solves_per_s"], 2),
    }))


if __name__ == "__main__":
    main()
