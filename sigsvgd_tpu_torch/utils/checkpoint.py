"""Checkpoint and resume for long runs (port of
``sigsvgd_tpu/utils/checkpoint.py``, on ``torch.save`` in place of orbax).

A state is any tree of NamedTuples, tuples, lists and dicts over tensors
(controller and filter states, SVGD and optimizer states, particles, a
generator's state). It is saved as plain dicts and lists of CPU tensors in
``<path>/state.pt`` and read back with ``torch.load(weights_only=True)``;
with a ``template`` the restore takes the template's structure and each
tensor its template leaf's dtype and device (the shape is the saved one).
Checkpoints of a run are the directories ``step_<n>`` under its root;
:func:`latest_checkpoint` finds the newest. The port does not read orbax
checkpoints.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _to_plain(node):
    if _is_namedtuple(node):
        return {f: _to_plain(v) for f, v in zip(node._fields, node)}
    if isinstance(node, (tuple, list)):
        return [_to_plain(v) for v in node]
    if isinstance(node, dict):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(node))
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    return node


def _fill(template, plain, where: str = "state"):
    if _is_namedtuple(template):
        return type(template)(*(_fill(t, plain[f], f"{where}.{f}")
                                for f, t in zip(template._fields, template)))
    if isinstance(template, (tuple, list)):
        if len(plain) != len(template):
            raise ValueError(f"{where}: {len(plain)} entries saved, the template has "
                             f"{len(template)}")
        return type(template)(_fill(t, p, f"{where}[{i}]")
                              for i, (t, p) in enumerate(zip(template, plain)))
    if isinstance(template, dict):
        return {k: _fill(t, plain[k], f"{where}.{k}") for k, t in template.items()}
    if isinstance(template, torch.Tensor):  # the saved shape, the template's dtype
        return plain.to(dtype=template.dtype, device=template.device)
    return plain


def save_checkpoint(path: str | Path, state: Any, force: bool = True) -> None:
    """Write ``state`` to the directory ``path`` (replaced when ``force``),
    through a temporary directory beside it."""
    path = Path(path).resolve()
    if path.exists() and not force:
        raise FileExistsError(f"checkpoint exists: {path}")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".tmp-{path.name}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(_to_plain(state), tmp / STATE_FILE)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_checkpoint(path: str | Path, template: Optional[Any] = None) -> Any:
    """The state saved at ``path``: plain dicts and lists of CPU tensors, or
    with ``template`` its structure, dtypes and devices."""
    plain = torch.load(Path(path).resolve() / STATE_FILE, weights_only=True)
    return plain if template is None else _fill(template, plain)


def latest_checkpoint(root: str | Path) -> Optional[Path]:
    """Newest checkpoint directory under ``root`` (named ``step_<n>``)."""
    root = Path(root)
    if not root.exists():
        return None
    cands = sorted(
        (p for p in root.iterdir() if p.is_dir() and p.name.startswith("step_")),
        key=lambda p: int(p.name.split("_")[1]),
    )
    return cands[-1] if cands else None
