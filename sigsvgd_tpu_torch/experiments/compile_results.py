"""Result compilation: experiment artifacts into metric tables (port of
``sigsvgd_tpu/experiments/compile_results.py``): success rates (max
occupancy ≤ 0.2 and max self-collision ≤ 0.2), end-effector path lengths,
episode costs and steps, aggregated over seeds by method into a markdown
table.

Run: ``python -m sigsvgd_tpu_torch.experiments.compile_results ROOT --kind planning|maze``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..utils.helper import load_progress

SUCCESS_THRESHOLD = 0.2  # reference compile_robot_results.py:22-41


def compile_planning_results(root: Path) -> List[Dict]:
    """Scan ``root/<request>-<seed>/<method>/data.pkl`` artifacts and compute
    per-method success/ee-length aggregates."""
    rows: Dict[str, Dict[str, list]] = {}
    for data_file in sorted(root.glob("**/data.pkl")):
        method = data_file.parent.name
        data = load_progress(data_file.parent)
        metrics = data.get("metrics", {})
        if not metrics:
            continue
        bucket = rows.setdefault(method, {"success": [], "ee_len": []})
        success = np.asarray(metrics["success"])
        bucket["success"].append(success.any())  # any particle succeeded
        if success.any():
            lens = np.asarray(metrics["ee_path_length"])[success]
            bucket["ee_len"].append(lens.min())
    out = []
    for method, b in sorted(rows.items()):
        out.append(
            {
                "method": method,
                "n_runs": len(b["success"]),
                "success_rate": float(np.mean(b["success"])) if b["success"] else 0.0,
                "mean_best_ee_length": float(np.mean(b["ee_len"])) if b["ee_len"] else None,
            }
        )
    return out


def compile_maze_results(root: Path) -> List[Dict]:
    """Aggregate maze episodes: steps to goal, total cost, crash rate."""
    rows: Dict[str, Dict[str, list]] = {}
    for data_file in sorted(root.glob("**/data.pkl")):
        method = data_file.parent.parent.name
        data = load_progress(data_file.parent)
        bucket = rows.setdefault(
            method, {"steps": [], "cost": [], "reached": []}
        )
        bucket["steps"].append(int(data.get("steps", len(data.get("actions", [])))))
        bucket["cost"].append(float(np.sum(data.get("costs", [0.0]))))
        bucket["reached"].append(bool(data.get("reached_goal", False)))
    out = []
    for method, b in sorted(rows.items()):
        out.append(
            {
                "method": method,
                "episodes": len(b["steps"]),
                "mean_steps": float(np.mean(b["steps"])),
                "mean_cost": float(np.mean(b["cost"])),
                "goal_rate": float(np.mean(b["reached"])),
            }
        )
    return out


def to_markdown(rows: List[Dict]) -> str:
    if not rows:
        return "(no results)"
    cols = list(rows[0].keys())
    lines = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for r in rows:
        lines.append(
            "| " + " | ".join(
                f"{r[c]:.3f}" if isinstance(r[c], float) else str(r[c]) for c in cols
            ) + " |"
        )
    return "\n".join(lines)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("root", type=Path)
    parser.add_argument("--kind", default="planning", choices=["planning", "maze"])
    args = parser.parse_args()
    rows = (
        compile_planning_results(args.root)
        if args.kind == "planning"
        else compile_maze_results(args.root)
    )
    print(to_markdown(rows))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
