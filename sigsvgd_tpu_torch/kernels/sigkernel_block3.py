"""λ=3 symmetric signature-kernel Gram + gradient: K2 and its plain twin.

Port of ``sigsvgd_tpu/kernels/pallas_sigkernel_block3.py::block3_gram_and_grad``.
``block3_gram_and_grad(X, h)`` returns ``(K [n, n], dX [n, L, C])`` with
``dX = ½·∂Σ_{ab}K_ab/∂X``, the same contract as K1's at dyadic order 3.

The function, shared by the twin and the kernel:

* statics ``g[p, q] = exp(-|x'_p - y'_q|²)`` on paths scaled by ``rsqrt(h)``.
  The JAX kernel forms ``d² = |x'|² + |y'|² - 2x'·y'`` and clamps it at 0;
  here ``d²`` is the sum of squared differences, which is the same function
  (never negative, so the clamp and its masked gradient are inert: where
  ``d² = 0`` the gradient ``2(x' - y')`` is 0 as well);
* ``z = inc/64`` per coarse cell, shared with ``A = 1 + z/2 + z²/12`` and
  ``B = 1 - z²/12`` by its 8×8 fine cells, and the fine-grid recurrence
  ``k[i+1, j+1] = (k[i+1, j] + k[i, j+1])·A - k[i, j]·B`` with the product
  by ``A`` fused into the subtraction (one rounding), as XLA compiles the
  JAX kernel's sweep. In fp32 ``A - 1 ≈ z/2`` keeps only a few digits and
  every ``A`` serves 64 fine cells, so these roundings are what sets fp32
  K's distance from fp64; rounding where the JAX kernel rounds keeps the
  port's K close to the JAX package's;
* cotangent seed 2 off the diagonal and 1 on it over the pairs ``a ≤ b``.

On a CPU tensor the wrapper runs :func:`block3_gram_and_grad_plain`; on a
CUDA tensor it launches the hand-written kernel in
``csrc/sigkernel_block3.cu`` or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._build import load
from .sigkernel_block import (
    MAX_C, MAX_L, MAX_LC, NARROW_C, SPAN_CAP, SPAN_TEMPLATES, THREADS, _cdiv, _tile_list,
    _tile_list_len, block_lanes, block_spans, kernel_lanes, lanes_instantiations, span_cap,
    tile_mask, tile_pairs, tile_shard,
)
from .sigkernel_fused import _M, fused_pairs_plain, grid_forward, pair_statics

# tile rows (csrc/sigkernel_block3.cu); the envelope is K1's (MAX_L, MAX_C,
# MAX_LC, NARROW_C)
TILE_ROWS = 8


def block3_supported(n: int, L: int, C: int, h) -> bool:
    """Shapes K2 takes on the card: a bandwidth, n ≥ 2, 2 ≤ L ≤ 64 and
    either C ≤ 3 or C ≤ 8 with L·C ≤ 128 (one kernel instantiation per span
    template and channel count, ``lanes_instantiations``). This holds the
    JAX package's block3 envelope (C ≤ 8, L·C ≤ 128, ly1 ≤ 48). Within
    these bounds a pair's fine row spreads over at most 16 lanes of at most
    5 coarse columns each (3 at C > 3, :func:`block3_lanes`), a block's
    shared memory (:func:`block3_plan`, at most 46 KB) fits Hopper's
    227 KB, and only the band-top checkpoints go to device memory, so at
    C ≤ 3 L is not bound by on-chip memory as it is on the TPU
    (ly1 ≤ 48)."""
    return (h is not None and n >= 2 and 2 <= L <= MAX_L and 1 <= C <= MAX_C
            and (C <= NARROW_C or L * C <= MAX_LC))


def block3_flops(n: int, L: int, C: int) -> float:
    """fp32 operations the function needs, counting an ``exp`` as one and
    each value once (K2 reconstructs the primal in its backward; that work
    is not counted): per pair ``(8(L-1))²`` fine cells at 14 (4 forward
    update, 5 adjoint, 5 dz sums), ``(L-1)²`` coarse cells at ``36 + 6C``
    (z, A, B and the pull-back through two static nodes) and ``L²`` static
    nodes at ``2C+3``."""
    pairs = n * (n + 1) // 2
    g = _M * (L - 1)
    per_pair = g * g * 14 + (L - 1) ** 2 * (36 + 6 * C) + L * L * (2 * C + 3)
    return float(pairs * per_pair)


def block3_bytes(n: int, L: int, C: int) -> float:
    """Bytes K2 must move: X read once, K and dX written once."""
    return 4.0 * (n * L * C + n * n + n * L * C)


# ---------------------------------------------------------------------------
# Plain PyTorch twin: the λ=3 pair twin of ``sigkernel_fused`` on the pairs
# a ≤ b (vectorised over the pairs, the fine grid swept by anti-diagonals,
# an explicit adjoint on the stored grid).
# ---------------------------------------------------------------------------


def _scale(X: torch.Tensor, h) -> torch.Tensor:
    return torch.rsqrt(torch.as_tensor(h, dtype=X.dtype, device=X.device))


def _pair_tiles(X: torch.Tensor, h, iu: torch.Tensor, ju: torch.Tensor):
    """Scaled path tiles ``x, y [L, C, P]`` of the pairs ``(iu, ju)``."""
    Xs = X * _scale(X, h)
    return Xs[iu].permute(1, 2, 0).contiguous(), Xs[ju].permute(1, 2, 0).contiguous()


def block3_gram_and_grad_plain(X: torch.Tensor, h, pairs_per_chunk: int | None = None,
                               pairs=None):
    """The K2 contract in plain PyTorch. Stores the fine grid, its adjoint
    and their products (about ``6·(8L)²`` values per pair), so it suits
    small shapes; ``pairs_per_chunk`` bounds that memory by solving the
    pairs that many at a time. :func:`block3_gram_plain` gives K alone
    without the grid. With ``pairs = (iu, ju)``, a subset of the pairs
    a ≤ b, K holds only theirs (zero elsewhere) and dX only their terms."""
    n = X.shape[0]
    iu, ju = pairs if pairs is not None else torch.triu_indices(n, n, device=X.device)
    step = max(1, pairs_per_chunk or iu.shape[0])
    K = torch.zeros(n, n, dtype=X.dtype, device=X.device)
    dX = torch.zeros_like(X)
    for p0 in range(0, iu.shape[0], step):
        i, j = iu[p0:p0 + step], ju[p0:p0 + step]
        seed = torch.where(i == j, 1.0, 2.0).to(X.dtype)
        kval, gx, gy = fused_pairs_plain(*_pair_tiles(X, h, i, j), seed)
        K[i, j] = kval
        K[j, i] = kval
        dX.index_add_(0, i, gx.permute(2, 0, 1))
        dX.index_add_(0, j, gy.permute(2, 0, 1))
    return K, 0.5 * _scale(X, h) * dX


def block3_gram_plain(X: torch.Tensor, h) -> torch.Tensor:
    """K alone, by the twin's forward sweep without the stored grid (two
    diagonals per pair)."""
    n = X.shape[0]
    iu, ju = torch.triu_indices(n, n, device=X.device)
    A, B = pair_statics(*_pair_tiles(X, h, iu, ju))[2:]
    kval, _ = grid_forward(A, B, keep_grid=False)
    K = torch.empty(n, n, dtype=X.dtype, device=X.device)
    K[iu, ju] = kval
    K[ju, iu] = kval
    return K


# ---------------------------------------------------------------------------
# Kernel plan and wrapper.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block3Plan:
    """How K2 lays out one call: ``g`` lanes a pair, each holding a span of
    whole coarse columns (``spans`` [g] widths, at most ``span``, the
    template); tiles of ``tile_rows`` × ``tile_cols`` pairs, one a block at a
    time; ``blocks`` persistent blocks walk the ``tiles`` of the work list.
    ``scratch_floats`` is the band-top checkpoints' buffer (all blocks),
    ``smem_bytes`` a block's shared memory, ``traffic_bytes`` the device-
    memory traffic of the call (:func:`block3_plan`)."""
    g: int
    span: int
    spans: tuple
    tile_rows: int
    tile_cols: int
    pairs_per_block: int
    steps: int
    tiles: int
    blocks: int
    scratch_floats: int
    smem_bytes: int
    traffic_bytes: float

    @property
    def scratch_mib(self) -> float:
        return self.scratch_floats * 4 / 2**20


# K2's lanes and spans over the L - 1 coarse columns: K1's rule
# (sigkernel_block.py), with the tile list. ``block3_lanes(L)`` is the rule
# at C ≤ 3 (K5's too); K2 takes ``kernel_lanes(L, C)``.
block3_lanes = block_lanes
block3_spans = block_spans


def _pipeline_steps(L: int, g: int) -> int:
    """Steps of a group's pipeline over a tile column's 8 pairs: 8(L-1)
    bands, the last lane starting g - 1 steps after the first."""
    return TILE_ROWS * (L - 1) + g - 1


def block3_scratch_floats(L: int, C: int) -> int:
    """Device scratch per persistent block, in floats: for each of its 4
    warps and each pipeline step, the 32 lanes' span of a band top row
    (8·span floats each) and each group's right-edge column (8 floats)."""
    g, span = kernel_lanes(L, C)
    return THREADS // 32 * _pipeline_steps(L, g) * (32 * _M * span + 32 // g * _M)


def block3_plan(n: int, L: int, C: int, blocks: int) -> Block3Plan:
    """K2's plan for ``X [n, L, C]`` over ``blocks`` persistent blocks, the
    count the card reports (:func:`block3_grid`).

    ``smem_bytes`` (csrc ``smem_floats``): the tile's scaled paths (the
    column paths at a padded node stride), each warp's row-path sums
    [8][4][L·C] and each lane's column-path sums [(span+1)·C].
    ``traffic_bytes``: each pair a ≤ b writes its band tops (8(L-1) floats a
    band) and its right-edge column (8 a band) once and reads them once; X
    is read once (it stays in L2), K and dX written once, the per-tile
    partials written and read once. No fine row or adjoint row goes to
    device memory."""
    g, span = kernel_lanes(L, C)
    tc = THREADS // g
    l1 = L - 1
    tiles = _tile_list_len(n, tc)
    smem = 4 * (L * C * TILE_ROWS + L * (C * tc + 1) + TILE_ROWS * 4 * L * C
                + (span + 1) * C * THREADS)
    pairs = n * (n + 1) // 2
    checkpoints = 2 * pairs * l1 * (_M * l1 + _M)
    partials = 2 * tiles * (TILE_ROWS + tc) * L * C
    return Block3Plan(
        g=g, span=span, spans=tuple(block3_spans(L, g)), tile_rows=TILE_ROWS,
        tile_cols=tc, pairs_per_block=TILE_ROWS * tc, steps=_pipeline_steps(L, g),
        tiles=tiles, blocks=blocks, scratch_floats=blocks * block3_scratch_floats(L, C),
        smem_bytes=smem,
        traffic_bytes=4.0 * (checkpoints + partials + n * L * C + n * n + n * L * C))


def _lib():
    lib = load("sigkernel_block3")
    lib.sigkernel_block3_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sigkernel_block3_grid.restype = ctypes.c_int
    lib.sigkernel_block3_gram_grad.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.sigkernel_block3_gram_grad.restype = ctypes.c_int
    return lib


def block3_grid(n: int, L: int, C: int, device) -> tuple[torch.Tensor, int]:
    """The tile list of a K2 launch on ``device`` and its number of
    persistent blocks (those resident on the card, at most one per tile):
    each block walks the list, taking about ``tiles / blocks`` tiles."""
    g, span = kernel_lanes(L, C)
    tiles = _tile_list(n, THREADS // g, device)
    blocks = ctypes.c_int(0)
    rc = _lib().sigkernel_block3_grid(L, C, g, span, tiles.shape[0], ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K2 occupancy query failed: cudaError {rc}")
    return tiles, blocks.value


def block3_gram_and_grad(X: torch.Tensor, h, shard=None):
    """``(K, dX)`` for paths ``X [n, L, C]`` and RBF bandwidth ``h`` (float or
    0-d tensor). CPU tensors take the plain twin; CUDA tensors launch K2 and
    add one to ``block3_gram_and_grad.launches``. ``shard = (ndev, rank)``
    takes rank's tiles of ``tile_shard`` only, as K1's wrapper does: K holds
    their pairs (zero elsewhere) and dX their terms, and K2's reduction reads
    only the subset's slots."""
    if X.device.type == "cpu":
        if shard is None:
            return block3_gram_and_grad_plain(X, h)
        n, L, C = X.shape
        tc = THREADS // kernel_lanes(L, C)[0]
        tiles = tile_shard(_tile_list(n, tc, X.device), *shard)
        return block3_gram_and_grad_plain(X, h, pairs=tile_pairs(tiles, n, tc))
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 3 or not X.is_contiguous():
        raise ValueError("K2 takes a contiguous fp32 [n, L, C] tensor")
    n, L, C = X.shape
    if not block3_supported(n, L, C, h):
        raise NotImplementedError(
            f"shape {(n, L, C)} is outside K2's envelope (L ≤ {MAX_L}, C ≤ "
            f"{NARROW_C} or C ≤ {MAX_C} with L·C ≤ {MAX_LC}); "
            "SignatureKernel.gram_and_grad sends such shapes to the λ=3 pair "
            "list (K4, or K5 beyond C = 8), or beyond ly1 = 48 to the "
            "wavefront (sigkernel.solve_goursat_pde)"
        )
    g, span = kernel_lanes(L, C)
    tc = THREADS // g
    tiles, blocks = block3_grid(n, L, C, X.device)
    present = None
    if shard is not None:
        tiles = tile_shard(tiles, *shard)
        blocks = min(blocks, tiles.shape[0])
        present = tile_mask(tiles, n, tc)
    n_tiles = tiles.shape[0]
    if n_tiles == 0:
        return torch.zeros(n, n, dtype=X.dtype, device=X.device), torch.zeros_like(X)
    # the path scale rsqrt(h), formed as the twin forms it
    s_t = torch.rsqrt(torch.as_tensor(h, dtype=torch.float32, device=X.device)).reshape(1)
    K = (torch.empty if present is None else torch.zeros)(
        n, n, dtype=X.dtype, device=X.device)
    dX = torch.empty_like(X)
    rowpart = torch.empty(_cdiv(n, tc), n, L * C, dtype=X.dtype, device=X.device)
    colpart = torch.empty(_cdiv(n, TILE_ROWS), n, L * C, dtype=X.dtype, device=X.device)
    scratch = torch.empty(blocks * block3_scratch_floats(L, C), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _lib().sigkernel_block3_gram_grad(
        X.data_ptr(), s_t.data_ptr(), tiles.data_ptr(), K.data_ptr(),
        dX.data_ptr(), rowpart.data_ptr(), colpart.data_ptr(),
        scratch.data_ptr(), None if present is None else present.data_ptr(), n_tiles,
        blocks, n, L, C, g, span, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    block3_gram_and_grad.launches += 1
    return K, dX


block3_gram_and_grad.launches = 0


def block3_tiles_ks_partial(X: torch.Tensor, h, s: torch.Tensor, ndev: int, rank: int):
    """Rank ``rank``'s partial ``(K@s [n, d], dX [n, L, C])`` over its tiles
    of ``ndev`` (K2 on the card, one launch; the twin on the CPU): the sums
    over the ranks are ``(K@s, dX)`` of :func:`block3_gram_and_grad`. Port of
    the JAX package's ``block3_tiles_ks_partial`` on this kernel's own tile
    list (its dX already halved; ``K@s`` as K1's partial forms it)."""
    K, dX = block3_gram_and_grad(X, h, shard=(ndev, rank))
    return K @ s, dX
