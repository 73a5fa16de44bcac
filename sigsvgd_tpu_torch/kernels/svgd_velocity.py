"""Fused RBF Stein velocity: K9 and its plain twin.

Port of ``sigsvgd_tpu/kernels/pallas_svgd.py``. For flattened particles
``x [N, D]``, scores ``s [N, D]`` and a bandwidth ``h``,

    φ_i = ( Σ_j K_ij s_j − (Σ_j K_ij x_j − (Σ_j K_ij) x_i) / h² ) / N,
    K_ij = exp(−½ ||x_i − x_j||² / h²).

On a CPU tensor :func:`fused_rbf_velocity` runs :func:`rbf_velocity_plain`
(the matmul form of ``xla_rbf_velocity``); on a CUDA tensor it launches the
hand-written kernel in ``csrc/svgd_velocity.cu`` or raises. That kernel runs
its three products on the tensor cores in 3xTF32, in two kernels a chunk of
the Gram: kernel A stores a chunk of K (at most :data:`CHUNK_BYTES`, so it
stays in the L2), kernel B multiplies it by ``[s | x]`` and writes φ.
:func:`velocity_plan` sizes the chunks.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.math import pw_dist_sq
from ._build import load

TILE = 64   # rows and columns of kernel A's Gram tile; rows of a kernel-B block
K_SLICE = 32  # the k-slice both kernels stream, and φ's columns of a kernel-B block
CHUNK_BYTES = 32 << 20  # a chunk of K, kept well inside the H100's 50 MB L2


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


class VelocityPlan(NamedTuple):
    """How K9 walks the Gram: row chunks of ``rows`` and column chunks of
    ``cols`` (each the whole of N when one chunk holds it), the K scratch
    in bytes, and the blocks each kernel launches for a full chunk."""

    rows: int
    cols: int
    row_chunks: int
    col_chunks: int
    scratch_bytes: int
    blocks_gram: int
    blocks_apply: int


def velocity_plan(N: int, D: int) -> VelocityPlan:
    """The chunks of K for ``x [N, D]``: the whole Gram when its padded
    ``[N, N]`` fits :data:`CHUNK_BYTES` (N ≤ 2880 at 32 MiB), else row chunks
    of all N columns, and when a 64-row strip of N columns does not fit
    (N > 131,072 at 32 MiB) square chunks, so that kernel B keeps rows to
    spread over the card."""
    cap = CHUNK_BYTES
    npad = _up(N, TILE)
    if npad * npad * 4 <= cap:
        rows = cols = N
    elif TILE * npad * 4 <= cap:
        rows, cols = cap // (4 * npad) // TILE * TILE, N
    else:
        rows = cols = math.isqrt(cap // 4) // TILE * TILE
    if rows < 1:
        raise ValueError(f"a chunk of {cap} bytes holds no 64 × 64 tile")
    rpad, cpad = _up(rows, TILE), _up(cols, TILE)
    return VelocityPlan(rows, cols, -(-N // rows), -(-N // cols), 4 * rpad * cpad,
                        (cpad // TILE) * (rpad // TILE),
                        -(-D // K_SLICE) * (rpad // TILE))


def velocity_supported(N: int, D: int) -> bool:
    """Shapes K9 takes: any N ≥ 1 and D ≥ 1 whose arrays index in 32 bits."""
    return N >= 1 and D >= 1 and N * D < 2**31


def velocity_flops(N: int, D: int) -> float:
    """Three products of ``2·N²·D`` (distances, ``K@s``, ``K@x``); the exp
    and the row sums are ``O(N²)`` and not counted."""
    return 3.0 * 2.0 * N * N * D


def velocity_tc_flops(N: int, D: int) -> float:
    """The TF32 tensor-core operations K9 issues: each of the three
    products in three passes (3xTF32)."""
    return 3.0 * velocity_flops(N, D)


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows16(a: torch.Tensor, ld: int) -> torch.Tensor:
    """``a`` contiguous with rows of ``ld`` floats (zero beyond its own)
    and 16-byte aligned, as the kernels' ``cp.async`` copies take it."""
    if a.shape[1] != ld:
        return torch.nn.functional.pad(a, (0, ld - a.shape[1]))
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


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
            "ROADMAP.md queue 2 (K9)"
        )
    ld = _up(D, 4)
    xc = _rows16(x - torch.mean(x, dim=0, keepdim=True), ld)
    sc = _rows16(s, ld)
    h_t = torch.as_tensor(h, dtype=torch.float32, device=x.device).reshape(1)
    plan = velocity_plan(N, D)
    kbuf = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=x.device)
    phi = torch.empty((N, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn()(xc.data_ptr(), sc.data_ptr(), h_t.data_ptr(), phi.data_ptr(),
                      kbuf.data_ptr(), N, D, ld, plan.rows, plan.cols, stream)
    if rc != 0:
        raise RuntimeError(f"K9 launch failed: cudaError {rc}")
    fused_rbf_velocity.launches += 1
    return phi


fused_rbf_velocity.launches = 0
