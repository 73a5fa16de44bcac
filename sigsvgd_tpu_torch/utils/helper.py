"""Experiment helpers the runners use (port of part of
``sigsvgd_tpu/utils/helper.py``): seeds, artifact saving and loading, and a
finiteness check over nested results."""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def generate_seeds(n: int, root_seed: int = 42) -> List[int]:
    """Deterministic list of experiment seeds."""
    rng = np.random.default_rng(root_seed)
    return [int(s) for s in rng.integers(0, 2**31 - 1, size=n)]


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return np.asarray(x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        if hasattr(x, "_fields"):
            return type(x)(*[_to_numpy(v) for v in x])
        return tuple(_to_numpy(v) for v in x)
    if isinstance(x, list):
        return [_to_numpy(v) for v in x]
    return x


def save_progress(folder_name: Path, data: Optional[Dict[str, Any]] = None,
                  config: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``data.pkl`` (tensors as numpy arrays) and ``config.json`` into
    ``folder_name``."""
    folder = Path(folder_name)
    folder.mkdir(parents=True, exist_ok=True)
    if data is not None:
        with open(folder / "data.pkl", "wb") as f:
            pickle.dump(_to_numpy(data), f)
    if config is not None:
        with open(folder / "config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)
    return folder


def load_progress(folder_name: Path) -> Dict[str, Any]:
    with open(Path(folder_name) / "data.pkl", "rb") as f:
        return pickle.load(f)


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` pairs, paths written as JAX's ``keystr`` writes them:
    ``['key']`` for a dict, ``.name`` for a named tuple, ``[i]`` for a
    sequence."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite_pytree(tree: Any, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming every floating leaf (tensor or
    array) of a nested dict/tuple/list that holds NaN or Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(path)
        elif hasattr(leaf, "dtype") and np.issubdtype(np.asarray(leaf).dtype, np.inexact):
            if not np.isfinite(np.asarray(leaf)).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
