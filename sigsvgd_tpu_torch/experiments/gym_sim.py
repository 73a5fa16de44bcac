"""Closed-loop MPC against gymnasium's physics (port of
``sigsvgd_tpu/experiments/gym_sim.py``): the controller plans with the
port's differentiable model while gymnasium's Pendulum-v1 moves the
system, a check that the model matches an external simulator.

gymnasium is imported when an episode runs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..controllers.dust import NO_DRAWS, DuStDraws
from ..models.pendulum import PendulumModel


def gym_pendulum_model(dt: float = 0.05) -> PendulumModel:
    """The pendulum at gymnasium Pendulum-v1's constants (g = 10; its
    dynamics are otherwise the same)."""
    return PendulumModel(dt=dt, g=10.0, mass=1.0, length=1.0)


def run_gym_pendulum(controller, cstate, n_steps: int = 200, seed: int = 0,
                     opt_steps: int = 2, generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[DuStDraws]] = None) -> Dict[str, Any]:
    """Closed-loop DuSt swing-up with gymnasium Pendulum-v1 as the system.

    The environment starts hanging down (θ = π, θ̇ = 0); each step the
    controller solves on its device from the environment's true state and
    the environment applies the first action. The controller's draws come
    from ``generator`` or, one a step, from ``draws``."""
    import gymnasium as gym

    device = controller.device
    env = gym.make("Pendulum-v1")
    env.reset(seed=seed)
    env.unwrapped.state = np.array([np.pi, 0.0])
    state = torch.tensor(env.unwrapped.state, dtype=torch.float32, device=device)
    states, actions, rewards = [state.cpu().numpy()], [], []
    for t in range(n_steps):
        a_seq, cstate, _ = controller.forward(
            state, cstate, None, generator, opt_steps=opt_steps,
            draws=draws[t] if draws is not None else NO_DRAWS)
        a_np = a_seq[0].cpu().numpy()
        _, reward, _, _, _ = env.step(a_np)
        state = torch.tensor(env.unwrapped.state, dtype=torch.float32, device=device)
        states.append(state.cpu().numpy())
        actions.append(a_np)
        rewards.append(float(reward))
    env.close()
    return {"states": np.stack(states), "actions": np.stack(actions),
            "rewards": np.asarray(rewards)}
