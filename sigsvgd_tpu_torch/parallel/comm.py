"""The collectives of the sharded solvers, on ``torch.distributed``, and
their inventory.

Every collective the ``parallel`` package issues goes through this module:
``lax.all_gather(tiled=True)`` becomes :func:`all_gather` (one
``all_gather_into_tensor``), ``psum``/``pmin``/``pmax`` become
:func:`all_reduce`, a ring ``ppermute`` becomes :func:`ring_shift` (batched
``isend``/``irecv`` to the next rank and from the previous one), and a
``psum`` a gradient must cross becomes :func:`all_reduce_sum_diff`, whose
backward sums the cotangents over the group as JAX's transpose of ``psum``
does. Each call is counted by kind and payload bytes in every open
:func:`record_collectives` (the port's counterpart of the JAX package's
HLO accounting, ``parallel/scaling.py``).

Transport: NCCL carries CUDA tensors. Two ranks that share one card must
use gloo (NCCL refuses two ranks on one device). Gloo carries CUDA tensors
for the gather and the all-reduces, so those run on the card's tensors;
its send and recv take host memory only (a card's pointer is not refused
up front, the transport fails later on the pair), so under gloo a ring
shift of CUDA tensors runs on host copies, copied back after. The compute
stays on the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_RECORDERS: List[Dict[str, Dict[str, int]]] = []

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@contextlib.contextmanager
def record_collectives() -> Iterator[Dict[str, Dict[str, int]]]:
    """Count the collectives issued inside the block: ``{kind: {"count": n,
    "bytes": payload}}`` with the JAX package's kind names ("all-gather",
    "all-reduce", "collective-permute"); the bytes of a gather are its
    output's, of a reduce its tensor's, of a permute what this rank sends."""
    stats: Dict[str, Dict[str, int]] = {}
    _RECORDERS.append(stats)
    try:
        yield stats
    finally:
        _RECORDERS.remove(stats)


def _record(kind: str, nbytes: int) -> None:
    for stats in _RECORDERS:
        d = stats.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gloo_on_card(group, tensors: Sequence[torch.Tensor]) -> bool:
    return any(t.is_cuda for t in tensors) and dist.get_backend(group) == "gloo"


def world_group(group=None):
    return dist.group.WORLD if group is None else group


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0 in rank order (``all_gather``
    with ``tiled=True``); not differentiable."""
    group = world_group(group)
    world = dist.get_world_size(group)
    x = x.detach().contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    _record("all-gather", _nbytes(out))
    return out


def all_reduce(x, op: str = "sum", group=None) -> torch.Tensor:
    """``psum``/``pmin``/``pmax`` of ``x`` over the group (a new tensor)."""
    group = world_group(group)
    y = torch.as_tensor(x).detach().clone().contiguous()
    dist.all_reduce(y, op=_OPS[op], group=group)
    _record("all-reduce", _nbytes(y))
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


def all_reduce_sum_diff(x: torch.Tensor, group=None) -> torch.Tensor:
    """``psum`` under autograd: the backward sums the cotangents over the
    group (every rank's output depends on every rank's input), so all ranks
    must run the backward together."""
    return _AllReduceSum.apply(x, world_group(group))


def ring_shift(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each rank sends ``tensors`` to the next rank of the group and returns
    those of the previous one (``ppermute`` with ``i → i+1``), batched into
    one ``batch_isend_irecv`` (on host copies under gloo with CUDA
    tensors)."""
    group = world_group(group)
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % world)
    prv = dist.get_global_rank(group, (me - 1) % world)
    sends = [t.detach().contiguous() for t in tensors]
    host = _gloo_on_card(group, sends)
    bufs = [t.cpu() for t in sends] if host else sends
    outs = [torch.empty_like(t) for t in bufs]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in bufs]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _record("collective-permute", sum(_nbytes(t) for t in sends))
    return [o.to(t.device) for o, t in zip(outs, sends)] if host else outs


def transport_report() -> Optional[dict]:
    """The default group's backend and the collectives that run on host
    copies under it (the ring shift under gloo), or None outside a process
    group."""
    if not dist.is_initialized():
        return None
    backend = str(dist.get_backend())
    return {"backend": backend, "host_copied": ["send_recv"] if backend == "gloo" else []}
