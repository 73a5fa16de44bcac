"""The arm-planning sweep: the Panda planned over scenes × requests × seeds ×
methods (port of ``sigsvgd_tpu/experiments/robot_planning.py``).

Each cell is one ``run_optimisation`` on the device, scored by
``evaluate_trajectory`` and audited against the exact oracles
(``verify_knot_trajectories``); with ``--use-learned`` the occupancy and
self-collision costs are MLPs trained per scene from the exact oracles.
Finished cells under ``--out`` are skipped on a re-run.

Run: ``python -m sigsvgd_tpu_torch.experiments.robot_planning --scenes pillars_4 \
      --methods pathsig svgd sgd --seeds 2 --quick`` (on the card; ``--device cpu``
for the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.learning.mlp import ProbModel, train_prob_model
from ..models.robot.panda import PandaRobot
from ..models.robot.scene import (
    SCENE_TAGS,
    PathRequest,
    get_scene,
    sample_occupancy_dataset,
    scene_sdf,
)
from ..models.robot.self_collision import sample_self_collision_dataset, self_collision
from ..utils.helper import generate_seeds, save_progress
from .planning import (
    PlannerConfig,
    PlanningProblem,
    create_body_points,
    evaluate_trajectory,
    run_optimisation,
    sdf_occupancy,
)
from .verify_trajectory import verify_knot_trajectories

N_CANDIDATES = 800
CLEARANCE = 0.10  # a request's endpoints keep this much scene clearance


def request_candidates(robot: PandaRobot, scene_tag: str):
    """The request sampler's candidates for a scene, ``[800, 7]`` float64,
    with their self-collision labels and scene clearances (numpy), each in
    one batched call on the robot's device. The numpy RNG is seeded from the
    tag's first four bytes, so the candidates are the same in every
    process."""
    seed = int.from_bytes(scene_tag.encode()[:4].ljust(4, b"_"), "little")
    rng = np.random.default_rng(seed)
    scene = get_scene(scene_tag, device=robot.device)
    lower, upper = (t.cpu().numpy() for t in robot.joint_limits())
    cands = rng.uniform(lower * 0.7, upper * 0.7, size=(N_CANDIDATES, 7))
    q = torch.tensor(cands, dtype=torch.float32, device=robot.device)
    with torch.no_grad():
        self_hit = self_collision(robot, q).cpu().numpy()
        body = create_body_points(robot.qs_to_joints_xs(q), 5)
        clearance = torch.amin(scene_sdf(scene, body), dim=-1).cpu().numpy()
    return cands, self_hit, clearance


def default_requests(robot: PandaRobot, scene_tag: str, n: int = 4) -> List[PathRequest]:
    """Deterministic start/goal pairs per scene: random configurations free
    of self-collision with at least ``CLEARANCE`` of scene clearance. Pair
    ``j`` is candidates ``2j`` and ``2j + 1``, kept only if both are free, so
    one candidate that flips across a threshold re-pairs no other request."""
    cands, self_hit, clearance = request_candidates(robot, scene_tag)
    ok = (self_hit == 0.0) & (clearance > CLEARANCE)
    reqs = []
    for j in range(len(cands) // 2):
        a, b = 2 * j, 2 * j + 1
        if ok[a] and ok[b]:
            reqs.append(PathRequest(tuple(map(float, cands[a])),
                                    tuple(map(float, cands[b]))))
        if len(reqs) == n:
            break
    return reqs


def build_problem(robot: PandaRobot, scene_tag: str, req: PathRequest, use_learned: bool,
                  occmap: Optional[ProbModel], self_pred: Optional[ProbModel],
                  timesteps: int) -> PlanningProblem:
    scene = get_scene(scene_tag, device=robot.device)
    if use_learned and occmap is not None:
        occupancy_fn = lambda x: occmap(x)[..., 0]  # noqa: E731
    else:
        occupancy_fn = sdf_occupancy(scene)
    self_fn = (lambda qs: self_pred(qs)[..., 0]) if self_pred is not None else None
    return PlanningProblem(
        robot=robot,
        q_start=torch.tensor(req.start, dtype=torch.float32, device=robot.device),
        q_target=torch.tensor(req.target, dtype=torch.float32, device=robot.device),
        occupancy_fn=occupancy_fn,
        self_collision_fn=self_fn,
        timesteps=timesteps,
    )


OCC_TRAIN_MARGIN = 0.03  # labels count sdf <= margin as occupied (train AND eval)


def train_scene_models(robot: PandaRobot, scene_tag: str, n_samples: int = 200_000,
                       epochs: int = 15):
    """Train the scene's occupancy MLP and the self-collision predictor from
    the exact oracles on the robot's device, each draw from its own seeded
    generator (seeds 0-3, as the JAX package's keys)."""
    dev = robot.device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    scene = get_scene(scene_tag, device=dev)
    pts, labels = sample_occupancy_dataset(scene, n_samples, margin=OCC_TRAIN_MARGIN,
                                           generator=gen(0))
    occmap = train_prob_model(gen(1), pts, labels, epochs=epochs, device=dev)
    qs, qlabels = sample_self_collision_dataset(robot, n_samples, generator=gen(2))
    self_pred = train_prob_model(gen(3), qs, qlabels, epochs=epochs, device=dev)
    return occmap, self_pred


def run_experiment(scene_tags: List[str], methods: List[str], n_seeds: int,
                   out_dir: Optional[Path], config: PlannerConfig,
                   use_learned: bool = False, n_requests: int = 2,
                   device=None) -> List[Dict]:
    """Every cell of the sweep: a row of its success rate, collision-free
    particles, best end-effector path length and wall seconds each."""
    robot = PandaRobot.create(device=device)
    seeds = generate_seeds(n_seeds)
    results = []
    for tag in scene_tags:
        scene = get_scene(tag, device=robot.device)
        occmap = self_pred = None
        if use_learned:
            occmap, self_pred = train_scene_models(robot, tag)
        for req_i, req in enumerate(default_requests(robot, tag, n=n_requests)):
            for seed in seeds:
                for method in methods:
                    cell = None if out_dir is None else (
                        Path(out_dir) / f"robot-{tag}/{req_i}-{seed}/{method}")
                    if cell is not None and (cell / "data.pkl").exists():
                        continue  # idempotent re-runs skip finished cells
                    cfg = dataclasses.replace(config, method=method)
                    problem = build_problem(robot, tag, req, use_learned, occmap,
                                            self_pred, cfg.timesteps)
                    gen = torch.Generator(device=robot.device).manual_seed(seed)
                    t0 = time.perf_counter()
                    x_final, _ = run_optimisation(problem, cfg, generator=gen)
                    if x_final.is_cuda:
                        torch.cuda.synchronize(x_final.device)
                    wall = time.perf_counter() - t0
                    with torch.no_grad():
                        metrics = evaluate_trajectory(problem, x_final)
                    audit = verify_knot_trajectories(
                        robot, scene, problem.q_start, problem.q_target, x_final,
                        timesteps=cfg.timesteps)
                    row = {
                        "scene": tag,
                        "request": req_i,
                        "seed": seed,
                        "method": method,
                        "success_rate": metrics["success"].float().mean().item(),
                        "n_collision_free": audit["n_valid"],
                        "best_ee_length": metrics["ee_path_length"].min().item(),
                        "wall_clock_s": round(wall, 2),
                    }
                    results.append(row)
                    print(json.dumps(row), flush=True)
                    if cell is not None:
                        save_progress(cell, data={"knots": x_final, "metrics": metrics,
                                                  "audit": audit},
                                      config=dataclasses.asdict(cfg))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenes", nargs="+", default=["pillars_4"],
                        choices=list(SCENE_TAGS))
    parser.add_argument("--methods", nargs="+", default=["pathsig", "svgd", "sgd"])
    parser.add_argument("--seeds", type=int, default=1)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--use-learned", action="store_true",
                        help="train + use learned occupancy/self-collision MLPs")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--requests", type=int, default=2,
                        help="path requests per scene (reference scale: 4)")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    config = PlannerConfig()
    if args.quick:
        config = PlannerConfig(n_iter=60, batch=8, depth=3, timesteps=60)
    return run_experiment(args.scenes, args.methods, args.seeds, args.out, config,
                          args.use_learned, n_requests=args.requests, device=args.device)


if __name__ == "__main__":
    main()
