"""Score estimators: cost functions to SVGD scores (port of
``sigsvgd_tpu/inference/score.py``).

The target density is ``p(x) ∝ exp(-cost(x))``, so ``∇log p = -∇cost`` by
autograd; the kernel terms come with the score per kernel family (the
identity kernel is plain SGD). A score function is called as
``score(x, generator)``; none of these draws.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import torch

from ..kernels.sigkernel import SignatureKernel
from ..kernels.signature import PathSigKernel
from .svgd import ScoreFn, ScoreResult

CostFn = Callable[[torch.Tensor], Tuple[torch.Tensor, Any]]  # x -> (cost [n], aux)


def _detach(aux):
    if isinstance(aux, dict):
        return {k: v.detach() for k, v in aux.items()}
    return aux.detach() if isinstance(aux, torch.Tensor) else aux


def _grad_neg_cost(cost_fn: CostFn, x: torch.Tensor):
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        cost, aux = cost_fn(xx)
        (g,) = torch.autograd.grad(cost.sum(), xx)
    return cost.detach(), _detach(aux), -g


def sgd_score(cost_fn: CostFn) -> ScoreFn:
    """Gradient descent as SVGD: identity Gram, zero repulsion."""

    def score(x, generator=None):
        cost, aux, grad_log_p = _grad_neg_cost(cost_fn, x)
        n = x.shape[0]
        return ScoreResult(
            grad_log_p=grad_log_p,
            k_xx=torch.eye(n, dtype=x.dtype, device=x.device),
            grad_k=torch.zeros_like(x), loss=cost, aux=aux,
        )

    return score


def svgd_score(cost_fn: CostFn, kernel) -> ScoreFn:
    """Analytic-kernel score: the kernel's Gram and gradient on the
    flattened particles, reshaped to the particles' shape."""

    def score(x, generator=None):
        cost, aux, grad_log_p = _grad_neg_cost(cost_fn, x)
        xf = x.reshape(x.shape[0], -1)
        k_xx, grad_k = kernel(xf, xf)
        return ScoreResult(grad_log_p=grad_log_p, k_xx=k_xx,
                           grad_k=grad_k.reshape(x.shape), loss=cost, aux=aux)

    return score


def pathsig_score(cost_fn: CostFn,
                  kernel: Union[SignatureKernel, PathSigKernel]) -> ScoreFn:
    """Signature-kernel score for path particles ``[n, L, C]``: the Gram on
    the paths and its repulsion gradient with the second argument detached
    (``SignatureKernel.gram_and_grad``, or ``PathSigKernel`` by autograd
    through the truncated signature)."""

    def score(x, generator=None):
        cost, aux, grad_log_p = _grad_neg_cost(cost_fn, x)
        if isinstance(kernel, SignatureKernel):
            k_xx, grad_k = kernel.gram_and_grad(x.detach().contiguous())
        else:
            k_xx, grad_k = kernel(x.detach(), x.detach())
        return ScoreResult(grad_log_p=grad_log_p, k_xx=k_xx, grad_k=grad_k,
                           loss=cost, aux=aux)

    return score
