"""Truncated path signatures and the path-signature RBF kernel (port of
``sigsvgd_tpu/kernels/signature.py``).

The depth-``d`` signature comes from Chen's identity as a loop over the
path's increments, batched over paths, the truncated tensor algebra held as
flattened per-degree tensors in the JAX package's layout (``_outer`` order,
degree ``k`` of ``C^k`` entries). With ``basepoint`` a zero point comes
first, and the first segment's exponential is the starting value, as in the
JAX scan. The JAX package has no Pallas kernel here (``lax.scan``), so these
torch ops are the port. Gradients come from autograd.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from .rbf import BaseKernel, GaussianKernel


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flattened tensor product of flattened tensors, batched over the
    leading dims."""
    return (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (-1,))


def _seg_exp(delta: torch.Tensor, depth: int) -> List[torch.Tensor]:
    """Levels of ``exp(δ)``: ``δ^{⊗k}/k!`` for k = 1..depth, flattened."""
    levels = [delta]
    for _ in range(depth - 1):
        levels.append(_outer(levels[-1], delta))
    return [lv * (1.0 / math.factorial(k + 1)) for k, lv in enumerate(levels)]


def _chen(sig: List[torch.Tensor], exp_lv: List[torch.Tensor]) -> List[torch.Tensor]:
    """Chen's identity: the levels of ``sig ⊗ exp(δ)``."""
    out = []
    for k in range(len(sig)):  # degree k+1
        term = sig[k] + exp_lv[k]
        for i in range(k):  # sig degree i+1 ⊗ exp degree k-i
            term = term + _outer(sig[i], exp_lv[k - i - 1])
        out.append(term)
    return out


def batch_signature(paths: torch.Tensor, depth: int, basepoint: bool = True) -> torch.Tensor:
    """Signatures of a batch of paths ``[..., L, C]`` → ``[..., sig_dim]``."""
    if basepoint:
        incs = torch.diff(paths, dim=-2,
                          prepend=torch.zeros_like(paths[..., :1, :]))
    else:
        incs = torch.diff(paths, dim=-2)
    sig = _seg_exp(incs[..., 0, :], depth)
    for t in range(1, incs.shape[-2]):
        sig = _chen(sig, _seg_exp(incs[..., t, :], depth))
    return torch.cat(sig, dim=-1)


def signature(path: torch.Tensor, depth: int, basepoint: bool = True) -> torch.Tensor:
    """Truncated signature of a single path ``[L, C]``: the flattened levels
    ``[C + C² + … + C^depth]`` (with ``basepoint`` a zero point is prepended,
    which makes the transform translation-sensitive)."""
    if path.ndim != 2:
        raise ValueError("signature expects a single path of shape [L, C]")
    return batch_signature(path, depth, basepoint)


def sig_dim(channels: int, depth: int) -> int:
    return sum(channels ** k for k in range(1, depth + 1))


@dataclasses.dataclass(frozen=True)
class PathSigKernel(BaseKernel):
    """Static RBF kernel on truncated-signature features,
    ``k(X, Y) = κ(S(X, d), S(Y, d))``. ``__call__`` takes paths
    ``[batch, L, C]`` and returns ``(K, dK)``, ``dK`` the gradient of ``ΣK``
    in the first argument with ``Y`` detached (autograd through the
    signature), or just ``K`` with ``compute_grad=False``."""

    static_kernel: BaseKernel = dataclasses.field(default_factory=GaussianKernel)
    depth: int = 3

    def gram(self, X: torch.Tensor, Y: torch.Tensor, h=None) -> torch.Tensor:
        xs = batch_signature(X, self.depth)
        ys = batch_signature(Y, self.depth)
        return self.static_kernel(xs, ys, h=h, compute_grad=False)

    def __call__(self, X, Y, h=None, compute_grad: bool = True, **_):
        if not compute_grad:
            return self.gram(X, Y, h)
        with torch.enable_grad():
            x = X.detach().requires_grad_(True)
            K = self.gram(x, Y.detach(), h)
            (dK,) = torch.autograd.grad(K.sum(), x)
        return K.detach(), dK
