"""Fused RBF Stein velocity: K9 and its plain twin.

Port of ``sigsvgd_tpu/kernels/pallas_svgd.py``. For flattened particles
``x [N, D]``, scores ``s [N, D]`` and a bandwidth ``h``,

    φ_i = ( Σ_j K_ij s_j − (Σ_j K_ij x_j − (Σ_j K_ij) x_i) / h² ) / N,
    K_ij = exp(−½ ||x_i − x_j||² / h²).

On a CPU tensor :func:`fused_rbf_velocity` runs :func:`rbf_velocity_plain`
(the matmul form of ``xla_rbf_velocity``); on a CUDA tensor it launches the
hand-written kernel in ``csrc/svgd_velocity.cu`` (its D-tiled variant above
``MAX_D``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.math import pw_dist_sq
from ._build import load

MAX_D = 800  # the untiled kernel's rows fit one block's shared memory up to here
D_TILE = 512  # φ columns per block of the D-tiled kernel (csrc/svgd_velocity.cu)


def velocity_supported(N: int, D: int) -> bool:
    """Shapes K9 takes: any N and D whose arrays index in 32 bits, the
    D-tiled kernel above ``MAX_D`` (at most 65535 column tiles)."""
    return N >= 1 and D >= 1 and N * D < 2**31 and -(-D // D_TILE) <= 65535


def velocity_flops(N: int, D: int) -> float:
    """Three products of ``2·N²·D`` (distances, ``K@s``, ``K@x``); the exp
    and the row sums are ``O(N²)`` and not counted."""
    return 3.0 * 2.0 * N * N * D


def velocity_bytes(N: int, D: int) -> float:
    """x and s read once, φ written once."""
    return 4.0 * 3 * N * D


def rbf_velocity_plain(x: torch.Tensor, s: torch.Tensor, h) -> torch.Tensor:
    """The K9 contract in plain PyTorch (``xla_rbf_velocity``'s matmul
    form)."""
    n = x.shape[0]
    k = torch.exp(-0.5 * pw_dist_sq(x, x) / h**2)
    grad_k = (k @ x - torch.sum(k, dim=1, keepdim=True) * x) / h**2
    return (k @ s - grad_k) / n


def _kernel_fn():
    fn = load("svgd_velocity").svgd_velocity
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_rbf_velocity(x: torch.Tensor, s: torch.Tensor, h) -> torch.Tensor:
    """φ for ``x, s [N, D]`` and bandwidth ``h`` (float or 0-d tensor, as the
    sampler's kernel computes it). CPU tensors take the plain twin; CUDA
    tensors launch K9 on the centred particles (φ is translation-invariant)
    and add one to ``fused_rbf_velocity.launches``."""
    if x.device.type == "cpu":
        return rbf_velocity_plain(x, s, h)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or s.dtype != torch.float32 or x.dim() != 2 \
            or s.shape != x.shape:
        raise ValueError("K9 takes fp32 x and s of one shape [N, D]")
    N, D = x.shape
    if not velocity_supported(N, D):
        raise NotImplementedError(
            f"[N, D] = [{N}, {D}] is outside K9's envelope (N·D < 2^31); "
            "ROADMAP.md queue 2, item 1 (K9)"
        )
    xc = (x - torch.mean(x, dim=0, keepdim=True)).contiguous()
    sc = s.contiguous()
    h_t = torch.as_tensor(h, dtype=torch.float32, device=x.device).reshape(1)
    phi = torch.empty_like(xc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn()(xc.data_ptr(), sc.data_ptr(), h_t.data_ptr(), phi.data_ptr(),
                      N, D, stream)
    if rc != 0:
        raise RuntimeError(f"K9 launch failed: cudaError {rc}")
    fused_rbf_velocity.launches += 1
    return phi


fused_rbf_velocity.launches = 0
