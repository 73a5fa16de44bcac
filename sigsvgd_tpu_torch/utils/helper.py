"""Experiment helpers the runners use (port of
``sigsvgd_tpu/utils/helper.py``): seeds and seeded generators, the project
root, artifact saving and loading with an optional snapshot of the caller's
session, and a finiteness check over nested results. The JAX package's
``enable_compile_cache`` (XLA's persistent compilation cache) has no
counterpart: PyTorch runs eagerly, and the port's kernels are built once
into ``build/kernels/`` and reused (``kernels/_build.py``)."""
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


def seed_key(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``, the port's
    counterpart of ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)


def get_project_root() -> Path:
    return Path(__file__).resolve().parents[2]


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
                  config: Optional[Dict[str, Any]] = None, session: bool = False) -> Path:
    """Write ``data.pkl`` (tensors as numpy arrays) and ``config.json`` into
    ``folder_name``, and with ``session`` a ``session.pkl`` snapshot of the
    caller's globals and locals (:func:`_dump_session`)."""
    folder = Path(folder_name)
    folder.mkdir(parents=True, exist_ok=True)
    if data is not None:
        with open(folder / "data.pkl", "wb") as f:
            pickle.dump(_to_numpy(data), f)
    if config is not None:
        with open(folder / "config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)
    if session:
        _dump_session(folder / "session.pkl")
    return folder


def _dump_session(path: Path) -> None:
    """Snapshot of the ``save_progress`` caller's globals and locals, name by
    name (tensors as numpy arrays); what does not pickle (modules, open
    handles, closures) is skipped and its name listed under
    ``__skipped__``."""
    import inspect

    frame = inspect.currentframe()
    g: Dict[str, Any] = {}
    try:
        caller = frame.f_back.f_back  # the save_progress caller
        g = dict(caller.f_globals)
        g.update(caller.f_locals)
    finally:
        del frame
    snap: Dict[str, Any] = {}
    skipped: List[str] = []
    for k, v in g.items():
        if k.startswith("__"):
            continue
        try:
            snap[k] = pickle.loads(pickle.dumps(_to_numpy(v)))
        except Exception:
            skipped.append(k)
    with open(path, "wb") as f:
        pickle.dump({"vars": snap, "__skipped__": sorted(skipped)}, f)


def load_session(folder_name: Path) -> Dict[str, Any]:
    """A ``save_progress(..., session=True)`` snapshot: ``{"vars": {...},
    "__skipped__": [...]}``."""
    with open(Path(folder_name) / "session.pkl", "rb") as f:
        return pickle.load(f)


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
