"""λ=3 signature kernel on given increments: K5 (forward, with or without
checkpoints; stable backward) and its plain twins.

Port of the increment half of ``sigsvgd_tpu/kernels/pallas_sigkernel.py``
(``solve_goursat_pde_pallas``, ``pallas_pair_values``). Pair ``p`` solves the
scaled increments ``z[:, :, p] = inc/64`` on its ``lx1 × ly1`` coarse grid,
``8·lx1 × 8·ly1`` fine cells, for any increments: linear statics on
unnormalised paths, RBF statics with more than 8 channels. The function,
shared by the twins and the kernels:

* ``A = 1 + z/2 + z²/12``, ``B = 1 − z²/12`` per coarse cell and the forward
  ``k[i, j] = (k[i, j−1] + k[i−1, j])·A − k[i−1, j−1]·B`` with the product by
  ``A`` fused into the subtraction, as the port's K2 and K4 round it;
* the checkpoints at the JAX package's spacing: the fine row at the top of
  every ``bpc = min(6, lx1)``-th band and of the last band (``ck [nslots,
  8·ly1+1, P]``);
* the backward, band by band from the top: the primal rebuilt toward +j
  from the band's top row, ``k[i−1, j] = (k[i, j] + k[i−1, j−1]·B)·A⁻¹ −
  k[i, j−1]`` (two fused multiply-adds, one reciprocal per coarse cell; it
  does not drift at large |z| as K2's −j scheme does), re-anchored at each
  checkpoint; the adjoint ``ĝ[i, j] = A(i, j+1)·ĝ[i, j+1] + A(i+1, j)·ĝ[i+1,
  j] − B(i+1, j+1)·ĝ[i+1, j+1]`` with the seed at ``(8·lx1, 8·ly1)``; and per
  coarse cell ``dz = (½ + z/6)·Σ ĝ·(k[i, j−1] + k[i−1, j]) + (z/6)·Σ ĝ·k[i−1,
  j−1]`` over its 64 fine nodes.

``z`` and ``dz`` are pair-minor ``[lx1, ly1, P]``; the twins keep the
checkpoints as ``[nslots, 8·ly1+1, P]``, the kernel in the lanes' layout of
:func:`tiled_plan` (:func:`twin_checkpoints` converts). On CPU tensors the
wrappers run the twins; on CUDA tensors they launch
``csrc/sigkernel_tiled.cu`` or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._build import load
from .sigkernel_block3 import SPAN_CAP, SPAN_TEMPLATES, block3_lanes, block3_spans  # noqa: F401
from .sigkernel_fused import _bands_per_ck, _fma, _n_ck_slots, grid_forward

_M = 8  # fine rows per band / fine cols per coarse cell (λ = 3)
_I6 = 1.0 / 6.0
_I12 = 1.0 / 12.0

# csrc/sigkernel_tiled.cu: the envelope, a block's threads and the pairs a
# lane group walks
MAX_LY1 = 48
THREADS = 128
TILE_ROWS = 8


def kernel_supported(lx1: int, ly1: int) -> bool:
    """Shapes ``csrc/sigkernel_tiled.cu`` takes: the JAX package's envelope
    (ly1 ≤ 48), any lx1 (bands stream; lx1 bounds only the checkpoints,
    which the caller's chunk plan accounts for)."""
    return lx1 >= 1 and 1 <= ly1 <= MAX_LY1


def tiled_flops(P: int, lx1: int, ly1: int, part: str = "forward") -> float:
    """fp32 operations of one call on ``P`` pairs, a fused multiply-add
    counted as two and each value once. Per coarse cell the forward forms
    ``A`` and ``B`` (6); per fine cell it takes 4. The backward adds a
    reciprocal and the dz combination per coarse cell (12 in all) and per
    fine cell 14: the primal rebuilt (4), the adjoint (5), the dz sums
    (5)."""
    cells = lx1 * ly1
    if part == "forward":
        return float(P * cells * (6 + 4 * _M * _M))
    if part == "backward":
        return float(P * cells * (12 + 14 * _M * _M))
    raise ValueError(f"unknown part {part!r}")


def residual_bytes(P: int, lx1: int, ly1: int) -> int:
    """Device bytes of the checkpoints ``ck`` of ``P`` pairs."""
    return 4 * P * _n_ck_slots(lx1, _bands_per_ck(lx1)) * (_M * ly1 + 1)


def tiled_bytes(P: int, lx1: int, ly1: int, part: str = "forward") -> float:
    """Bytes a call must move, each input read once and each output written
    once: the forward reads z and writes k and (``"forward"``) the
    checkpoints, or (``"values"``) k alone; the backward reads z, the
    checkpoints and the cotangent and writes dz."""
    z = 4.0 * P * lx1 * ly1
    if part == "values":
        return z + 4.0 * P
    if part == "forward":
        return z + 4.0 * P + residual_bytes(P, lx1, ly1)
    if part == "backward":
        return 2 * z + 4.0 * P + residual_bytes(P, lx1, ly1)
    raise ValueError(f"unknown part {part!r}")


def chunk_pair_bytes(lx1: int, ly1: int, C: int, device_type: str, rbf: bool) -> int:
    """Memory a pair of a pair-list chunk holds at its peak, the backward:
    on the card its checkpoints (counted at the twins' 8·ly1+1 floats a
    slot; the kernel's layout takes 8·ly1, and fewer than 1024/g padding
    pairs a call), z, dz and one more ``lx1·ly1`` temporary,
    for RBF statics two ``Lx·Ly`` grids (the exp's output and the clamp's
    mask that autograd keeps; linear statics keep none), and the gathered
    path tiles with their gradients (a [1024, 40, 2] triangle list on
    linear statics peaked at 25.9 KB a pair on the H100, this counts 29.6
    KB); on the CPU the twins' grids (the forward keeps the whole fine
    grid, the backward a checkpoint segment's primal and adjoint rows)."""
    if device_type == "cuda":
        grids = 3 * lx1 * ly1 + (2 * (lx1 + 1) * (ly1 + 1) if rbf else 0)
        return residual_bytes(1, lx1, ly1) + 4 * grids + 16 * (lx1 + ly1 + 2) * C
    return 32 * (_M * lx1 + 2) * (_M * ly1 + 2)


# ---------------------------------------------------------------------------
# The kernels' plan: lanes, spans, tiles and the checkpoints' layout.
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiled_lanes(ly1: int) -> tuple[int, int]:
    """``(g, span)``: K2's rule (:func:`block3_lanes`) with ly1 coarse
    columns: the fewest lanes a pair (a power of two) that leave no lane
    more than :data:`SPAN_CAP` of them, and the span template (3 or 5) that
    holds the widest span."""
    return block3_lanes(ly1 + 1)


def tiled_spans(ly1: int, g: int) -> list[int]:
    """Coarse columns of each lane: lane t holds ``[t·ly1/g, (t+1)·ly1/g)``."""
    return block3_spans(ly1 + 1, g)


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """How K5 lays out one call on ``P`` pairs: ``g`` lanes a pair, each
    holding a span of whole coarse columns (``spans``, at most ``span``, the
    template); tiles of ``tile_rows`` × ``tile_cols`` pairs (a group walks
    ``tile_rows`` pairs), one block each; ``fwd_steps`` / ``bwd_steps``
    pipeline steps a block; ``ring_floats`` the left edges a group keeps
    between its backward's two pipelines; ``smem_bytes`` a backward block's
    shared memory (a forward block takes none); ``scratch_bytes`` device
    scratch (none); ``ck_floats`` the checkpoints' device buffer;
    ``traffic_bytes`` the device-memory traffic of each launch (the forward
    with and without checkpoints, the backward). ``resident`` is the
    backward's blocks on the card at once, where known."""
    g: int
    span: int
    spans: tuple
    tile_rows: int
    tile_cols: int
    pairs_per_tile: int
    tiles: int
    nslots: int
    fwd_steps: int
    bwd_steps: int
    ring_floats: int
    smem_bytes: int
    scratch_bytes: int
    ck_floats: int
    traffic_bytes: dict
    resident: int | None

    @property
    def waves(self) -> float | None:
        return None if not self.resident else self.tiles / self.resident


def tiled_plan(P: int, lx1: int, ly1: int, blocks: int | None = None) -> TiledPlan:
    """K5's plan for ``P`` pairs of ``lx1 × ly1`` coarse cells; ``blocks``
    the backward blocks resident on the card at once (:func:`resident_blocks`),
    reported beside the launch's ``tiles`` blocks.

    ``smem_bytes`` (csrc ``bwd_smem_floats``): per thread the rebuild's top
    row, the adjoint row above the band and the next adjoint unit's
    checkpoint row (8·span each) and the left columns of the span's coarse
    cells after the first (8·(span−1)); per group the rings of lanes
    1..g−1, 2g−2t left edges of 9 floats.
    ``traffic_bytes``: the forward reads z once and writes k and, with
    checkpoints, each pair's slots once (8·ly1 floats a slot); the backward
    reads z and the slots once in each of its two pipelines, the cotangent
    once, and writes dz once. No fine row or adjoint row goes to device
    memory."""
    g, span = tiled_lanes(ly1)
    tc = THREADS // g
    npt = TILE_ROWS * tc
    tiles = _cdiv(P, npt)
    nslots = _n_ck_slots(lx1, _bands_per_ck(lx1))
    G = _M * ly1
    units = TILE_ROWS * lx1
    z = P * lx1 * ly1
    slots = P * nslots * G
    return TiledPlan(
        g=g, span=span, spans=tuple(tiled_spans(ly1, g)), tile_rows=TILE_ROWS, tile_cols=tc,
        pairs_per_tile=npt, tiles=tiles, nslots=nslots, fwd_steps=units + g - 1,
        bwd_steps=units + 2 * g - 1, ring_floats=g * (g - 1) * 9,
        smem_bytes=4 * THREADS * (_M * span * 3 + _M * (span - 1) + 9 * (g - 1)),
        scratch_bytes=0, ck_floats=tiles * npt * nslots * G,
        traffic_bytes={"forward": 4.0 * (z + P + slots), "values": 4.0 * (z + P),
                       "backward": 4.0 * (3 * z + 2 * slots + P)},
        resident=blocks)


def _ck_index(P: int, lx1: int, ly1: int, pairs: torch.Tensor, slot: int) -> torch.Tensor:
    """Float offsets ``[G, n]`` in the kernel's checkpoints of node columns
    1..8·ly1 of slot ``slot`` of the pairs ``pairs`` (csrc ``CkLayout``):
    per (tile, slot, warp, pipeline position) a block of the warp's 32/g
    pairs' rows, float4 ``i`` of the lane whose span starts at coarse column
    ``c0`` at ``(2·c0 + i)·32/g + q`` for the pair's group ``q`` in the
    warp."""
    plan = tiled_plan(P, lx1, ly1)
    g, tc = plan.g, plan.tile_cols
    ngw = 32 // g
    dev = pairs.device
    tile, rem = pairs // plan.pairs_per_tile, pairs % plan.pairs_per_tile
    r, gi = rem // tc, rem % tc
    warp, q = gi // ngw, gi % ngw
    col = torch.arange(_M * ly1, device=dev)
    f4 = (col // 4)[:, None] * ngw + q[None]     # 2·c0 + i is the column's float4
    base = (((tile * plan.nslots + slot) * (THREADS // 32) + warp) * TILE_ROWS + r) * (
        ngw * 2 * ly1)
    return (base[None] + f4) * 4 + (col % 4)[:, None]


def twin_checkpoints(ck: torch.Tensor, lx1: int, ly1: int, P: int,
                     pairs: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's checkpoints ``ck`` of ``P`` pairs in the twins' layout
    ``[nslots, 8·ly1+1, n]`` for the pairs ``pairs`` (all by default);
    node column 0 is 1."""
    if pairs is None:
        pairs = torch.arange(P, device=ck.device)
    nslots = _n_ck_slots(lx1, _bands_per_ck(lx1))
    out = torch.ones(nslots, _M * ly1 + 1, pairs.numel(), dtype=ck.dtype, device=ck.device)
    for s in range(nslots):
        out[s, 1:] = ck[_ck_index(P, lx1, ly1, pairs, s)]
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch twins: vectorised over the pairs; the forward by
# anti-diagonals (K4's twin), the backward per checkpoint segment by
# wavefronts over the segment's rows (each node's arithmetic is the row
# sweep's).
# ---------------------------------------------------------------------------


def coefs(z: torch.Tensor):
    """``A, B`` of scaled increments, in the kernels' rounding order."""
    zz = z * z
    return (1.0 + 0.5 * z) + zz * _I12, 1.0 - zz * _I12


def _tops(lx1: int, bpc: int):
    """Bands whose top row is a checkpoint: every ``bpc``-th and the last."""
    return [b for b in range(lx1) if (b + 1) % bpc == 0 or b == lx1 - 1]


def tiled_forward_plain(z: torch.Tensor, with_ck: bool):
    """The twin of K5's forward on ``z [lx1, ly1, P]``: ``(k [P],)`` or
    ``(k, ck [nslots, 8·ly1+1, P])``."""
    lx1 = z.shape[0]
    A, B = coefs(z)
    kval, grid = grid_forward(A, B, keep_grid=with_ck)
    if not with_ck:
        return (kval,)
    tops = [_M * (b + 1) for b in _tops(lx1, _bands_per_ck(lx1))]
    return kval, grid[tops].contiguous()


def _rebuild(top: torch.Tensor, B, Ai, row0: int, rows: int) -> torch.Tensor:
    """Primal node rows ``row0 .. row0 + rows`` ``[rows+1, G+1, P]`` rebuilt
    toward +j from the top one, ``top [G+1, P]`` (node row ``row0 + rows``),
    by wavefronts ``(row0 + rows − i) + j``."""
    G1, P = top.shape
    G = G1 - 1
    K = torch.ones(rows + 1, G1, P, dtype=top.dtype, device=top.device)
    K[rows] = top
    dev = top.device
    for s in range(2, rows + G + 1):
        u = torch.arange(max(1, s - G), min(rows, s - 1) + 1, device=dev)
        r, j = rows - u, s - u          # node (row0 + r, j), from node row r+1
        ci, cj = (row0 + r) // _M, (j - 1) // _M
        t = _fma(K[r, j - 1], B[ci, cj], K[r + 1, j])
        K[r, j] = _fma(t, Ai[ci, cj], -K[r + 1, j - 1])
    return K


def _adjoint(gabove: torch.Tensor, Ap, Bp, row0: int, rows: int, seed):
    """Adjoint node rows ``row0+1 .. row0+rows`` ``[rows, G+2, P]`` (column
    G+1 zero) by wavefronts from the top right; ``gabove [G+2, P]`` is the
    row above, ``Ap``/``Bp`` the coefficients padded with a zero band and a
    zero column; ``seed`` (or None) lands on the top right node."""
    G2, P = gabove.shape
    G = G2 - 2
    L = torch.zeros(rows + 1, G2, P, dtype=gabove.dtype, device=gabove.device)
    L[rows] = gabove                    # index i - row0 - 1; rows = the row above
    dev = gabove.device
    for s in range(0, rows + G - 1):
        v = torch.arange(max(0, s - G + 1), min(rows - 1, s) + 1, device=dev)
        r, j = rows - 1 - v, G - (s - v)  # node (row0 + 1 + r, j)
        i = row0 + 1 + r
        a_r = Ap[(i - 1) // _M, j // _M]      # A(i, j+1)
        a_u = Ap[i // _M, (j - 1) // _M]      # A(i+1, j)
        b_u = Bp[i // _M, j // _M]            # B(i+1, j+1)
        g = _fma(a_r, L[r, j + 1], _fma(a_u, L[r + 1, j], -(b_u * L[r + 1, j + 1])))
        if seed is not None and s == 0:
            g = g + seed
        L[r, j] = g
    return L[:rows]


def tiled_backward_plain(z: torch.Tensor, ck: torch.Tensor, gout: torch.Tensor):
    """The twin of K5's backward: ``dz [lx1, ly1, P]``, the gradient of
    ``Σ_p gout[p]·k[p]`` with respect to the scaled increments, with the
    primal rebuilt from the checkpoints ``ck`` as the kernel rebuilds it."""
    lx1, ly1, P = z.shape
    G = _M * ly1
    bpc = _bands_per_ck(lx1)
    A, B = coefs(z)
    Ai = 1.0 / A
    Ap = torch.zeros(lx1 + 1, ly1 + 1, P, dtype=z.dtype, device=z.device)
    Bp = torch.zeros_like(Ap)
    Ap[:lx1, :ly1], Bp[:lx1, :ly1] = A, B
    dz = torch.empty_like(z)
    gabove = torch.zeros(G + 2, P, dtype=z.dtype, device=z.device)
    tops = _tops(lx1, bpc)
    for n, bt in enumerate(reversed(tops)):
        bb = tops[len(tops) - 2 - n] + 1 if n < len(tops) - 1 else 0
        nb = bt - bb + 1
        K = _rebuild(ck[bt // bpc], B, Ai, _M * bb, _M * nb)
        Lg = _adjoint(gabove, Ap, Bp, _M * bb, _M * nb, gout if n == 0 else None)
        gabove = Lg[0]                  # ĝ of node row 8·bb+1, for the segment below
        # per coarse cell: Σ ĝ[i, j]·(k[i, j-1] + k[i-1, j]) and Σ ĝ[i, j]·k[i-1, j-1]
        blk = (nb, _M, ly1, _M, P)
        lg = Lg[:, 1:G + 1].reshape(blk)
        s1 = (lg * (K[1:, :-1] + K[:-1, 1:]).reshape(blk)).sum((1, 3))
        s2 = (lg * K[:-1, :-1].reshape(blk)).sum((1, 3))
        zs = z[bb:bt + 1] * _I6
        dz[bb:bt + 1] = (0.5 + zs) * s1 + zs * s2
    return dz


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _lib():
    lib = load("sigkernel_tiled")
    lib.sigkernel_tiled_resident.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.sigkernel_tiled_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.sigkernel_tiled_bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    for fn in (lib.sigkernel_tiled_resident, lib.sigkernel_tiled_fwd, lib.sigkernel_tiled_bwd):
        fn.restype = ctypes.c_int
    return lib


def _check(z: torch.Tensor, what: str):
    if z.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {z.device}")
    if z.dtype != torch.float32 or z.dim() != 3 or not z.is_contiguous():
        raise ValueError(f"{what} takes contiguous fp32 [lx1, ly1, P] increments")
    lx1, ly1, P = z.shape
    if not kernel_supported(lx1, ly1):
        raise NotImplementedError(
            f"{lx1 + 1}x{ly1 + 1}-node paths are outside K5's envelope (ly1 ≤ "
            f"{MAX_LY1}); SignatureKernel takes them by the wavefront "
            "(sigkernel.solve_goursat_pde)"
        )
    return lx1, ly1, P


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def resident_blocks(ly1: int) -> tuple[int, int]:
    """Blocks of K5's forward and backward resident on one SM at once (the
    backward with its shared memory), by the card's occupancy query."""
    g, span = tiled_lanes(ly1)
    fwd, bwd = ctypes.c_int(0), ctypes.c_int(0)
    err = _lib().sigkernel_tiled_resident(ly1, g, span, ctypes.byref(fwd), ctypes.byref(bwd))
    if err != 0:
        raise RuntimeError(f"K5 occupancy query failed: cudaError {err}")
    return fwd.value, bwd.value


def tiled_forward(z: torch.Tensor, with_ck: bool):
    """K5's forward on ``z [lx1, ly1, P]``: ``(k,)``, or ``(k, ck)`` with the
    checkpoints. CPU tensors take the twin (``ck [nslots, 8·ly1+1, P]``);
    CUDA tensors launch the kernel (``ck`` flat, in the lanes' layout of
    :func:`tiled_plan`) and add one to ``tiled_forward.launches``."""
    if z.device.type == "cpu":
        return tiled_forward_plain(z, with_ck)
    lx1, ly1, P = _check(z, "K5")
    plan = tiled_plan(P, lx1, ly1)
    k = torch.empty(P, dtype=z.dtype, device=z.device)
    ck = torch.empty(plan.ck_floats, dtype=z.dtype, device=z.device) if with_ck else None
    err = _lib().sigkernel_tiled_fwd(z.data_ptr(), k.data_ptr(),
                                     ck.data_ptr() if with_ck else None, P, lx1, ly1,
                                     plan.g, plan.span, _bands_per_ck(lx1), plan.nslots,
                                     _stream(z))
    if err != 0:
        raise RuntimeError(f"K5 forward launch failed: cudaError {err}")
    tiled_forward.launches += 1
    return (k, ck) if with_ck else (k,)


def tiled_backward(z: torch.Tensor, ck: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """K5's backward: ``dz [lx1, ly1, P]``, the gradient of ``Σ gout·k``.
    CPU tensors take the twin; CUDA tensors launch the kernel and add one to
    ``tiled_backward.launches``."""
    if z.device.type == "cpu":
        return tiled_backward_plain(z, ck, gout)
    lx1, ly1, P = _check(z, "K5 backward")
    if gout.shape != (P,) or gout.dtype != torch.float32 or not gout.is_contiguous():
        raise ValueError("the cotangent must be a contiguous fp32 [P] tensor")
    plan = tiled_plan(P, lx1, ly1)
    if (ck.shape != (plan.ck_floats,) or ck.dtype != torch.float32 or not ck.is_contiguous()
            or ck.device != z.device):
        raise ValueError(f"ck must be K5's forward checkpoints, fp32 [{plan.ck_floats}]")
    dz = torch.empty_like(z)
    err = _lib().sigkernel_tiled_bwd(z.data_ptr(), ck.data_ptr(), gout.data_ptr(),
                                     dz.data_ptr(), P, lx1, ly1, plan.g, plan.span,
                                     _bands_per_ck(lx1), plan.nslots, _stream(z))
    if err != 0:
        raise RuntimeError(f"K5 backward launch failed: cudaError {err}")
    tiled_backward.launches += 1
    return dz


tiled_forward.launches = 0
tiled_backward.launches = 0


class _TiledSolve(torch.autograd.Function):
    """``k [P]`` of pair-minor scaled increments ``z [lx1, ly1, P]``. Under
    autograd the forward keeps its checkpoints for the backward; a streamed
    chunk that must not keep them runs under ``torch.utils.checkpoint``,
    which also drops its increments."""

    @staticmethod
    def forward(ctx, z):
        if not ctx.needs_input_grad[0]:
            return tiled_forward(z, with_ck=False)[0]
        k, ck = tiled_forward(z, with_ck=True)
        ctx.save_for_backward(z, ck)
        return k

    @staticmethod
    def backward(ctx, gout):
        z, ck = ctx.saved_tensors
        return tiled_backward(z, ck, gout.contiguous())


def solve_goursat_pde_tiled(inc: torch.Tensor, dyadic_order: int = 3) -> torch.Tensor:
    """``inc [B, lx1, ly1]`` coarse increments → ``[B]`` kernel values at
    dyadic order 3, differentiable: the counterpart of
    ``solve_goursat_pde_pallas``. The scaling and the transpose into the
    pair-minor layout are torch ops differentiated by autograd; only the
    solve carries the hand-written adjoint."""
    if dyadic_order != 3:
        raise ValueError("the tiled solve is specialised to dyadic order 3")
    z = (inc / 64.0).permute(1, 2, 0).contiguous()
    return _TiledSolve.apply(z)


def pair_increments(X: torch.Tensor, Y: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                    h, dyadic_order: int = 3) -> torch.Tensor:
    """Scaled increments ``z [lx1, ly1, P]`` of the pairs ``(X[ix], Y[iy])``,
    built pair-minor in torch as ``pallas_pair_values`` builds them in XLA
    (and the JAX package's pair-list statics for its wavefront): the cross
    term summed in channel order, linear statics (``h`` None) or RBF in the
    expand form ``exp(−max(‖x‖² + ‖y‖² − 2⟨x, y⟩, 0)/h)``, the double
    difference and ``/4^dyadic_order`` (``/64`` for K5)."""
    xt = X[ix].permute(1, 2, 0).contiguous()   # [Lx, C, P]
    yt = Y[iy].permute(1, 2, 0).contiguous()
    cross = xt[:, None, 0] * yt[None, :, 0]
    for c in range(1, X.shape[2]):
        cross = cross + xt[:, None, c] * yt[None, :, c]
    if h is None:
        g = cross
    else:
        xn, yn = (t[:, 0] * t[:, 0] for t in (xt, yt))
        for c in range(1, X.shape[2]):
            xn = xn + xt[:, c] * xt[:, c]
            yn = yn + yt[:, c] * yt[:, c]
        d2 = torch.clamp_min((xn[:, None] + yn[None]) - 2.0 * cross, 0.0)
        g = torch.exp(-d2 / h)
    return (((g[1:, 1:] - g[1:, :-1]) - g[:-1, 1:]) + g[:-1, :-1]) / float(4 ** dyadic_order)


def pair_values(X: torch.Tensor, Y: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                h) -> torch.Tensor:
    """Signature-kernel values ``k [P]`` of the pairs ``(X[ix], Y[iy])`` at
    dyadic order 3 on any statics (``h`` None: linear), differentiable with
    respect to X, Y and h: the counterpart of ``pallas_pair_values``."""
    return _TiledSolve.apply(pair_increments(X, Y, ix, iy, h))
