"""Accuracy audit of the learned collision models against the exact oracles
(port of ``sigsvgd_tpu/experiments/verify_learned.py``): classification
metrics of the occupancy MLP against the exact scene SDF and of the
self-collision predictor against the capsule oracle, on held-out samples
drawn from a seeded generator on the model's device.

Run: ``python -m sigsvgd_tpu_torch.experiments.verify_learned --scene table_pick``
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ..models.learning.mlp import ProbModel
from ..models.robot.panda import PandaRobot
from ..models.robot.scene import Scene, sample_occupancy_dataset
from ..models.robot.self_collision import sample_self_collision_dataset


def _metrics(pred: np.ndarray, label: np.ndarray, threshold: float = 0.5) -> Dict:
    """Accuracy, precision and recall at ``threshold`` and the
    threshold-free AUC (the models' inverse-frequency ``pos_weight`` shifts
    the sigmoid's operating point toward recall)."""
    hard = (pred >= threshold).astype(np.float32)
    tp = float(((hard == 1) & (label == 1)).sum())
    fp = float(((hard == 1) & (label == 0)).sum())
    fn = float(((hard == 0) & (label == 1)).sum())
    tn = float(((hard == 0) & (label == 0)).sum())
    # AUC by the rank-sum identity
    order = np.argsort(pred)
    ranks = np.empty(len(pred))
    ranks[order] = np.arange(1, len(pred) + 1)
    n_pos = max(label.sum(), 1)
    n_neg = max((1 - label).sum(), 1)
    auc = (ranks[label == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    return {
        "accuracy": (tp + tn) / max(len(label), 1),
        "precision": tp / max(tp + fp, 1),
        "recall": tp / max(tp + fn, 1),
        "auc": float(auc),
        "positive_rate": float(label.mean()),
        "threshold": threshold,
    }


def _predict(model: ProbModel, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(x)[:, 0].cpu().numpy()


def verify_occupancy_model(model: ProbModel, scene: Scene, n: int = 50_000,
                           seed: int = 123, pts=None) -> Dict:
    """Against the exact occupancy at the margin the model was trained on
    (otherwise the ``0 < sdf <= margin`` band counts as false positives), on
    ``n`` points drawn from ``seed`` or on the given ``pts``."""
    from .robot_planning import OCC_TRAIN_MARGIN

    gen = torch.Generator(device=scene.device).manual_seed(seed)
    pts, labels = sample_occupancy_dataset(scene, n, margin=OCC_TRAIN_MARGIN,
                                           generator=gen, pts=pts)
    return _metrics(_predict(model, pts), labels)


def verify_self_collision_model(model: ProbModel, robot: PandaRobot, n: int = 50_000,
                                seed: int = 123, qs=None) -> Dict:
    """Against the capsule oracle on ``n`` configurations drawn from
    ``seed`` or on the given ``qs``."""
    gen = torch.Generator(device=robot.device).manual_seed(seed)
    qs, labels = sample_self_collision_dataset(robot, n, generator=gen, qs=qs)
    return _metrics(_predict(model, qs), labels)


def main():
    from ..models.robot.scene import get_scene
    from .robot_planning import train_scene_models

    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="table_pick")
    parser.add_argument("--samples", type=int, default=100_000)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()

    robot = PandaRobot.create(device=args.device)
    scene = get_scene(args.scene, device=args.device)
    occmap, self_pred = train_scene_models(robot, args.scene, n_samples=args.samples)
    print(json.dumps({
        "occupancy": verify_occupancy_model(occmap, scene),
        "self_collision": verify_self_collision_model(self_pred, robot),
    }, indent=2))


if __name__ == "__main__":
    main()
