"""λ=3 pair-list signature kernel with the RBF statics inside the kernels:
K4 (forward, fp32 backward), K6 (bf16 delta-form backward) and their plain
twins.

Port of the fused-statics route of ``sigsvgd_tpu/kernels/pallas_sigkernel.py``
(``pallas_pair_gram_fused``). Pair ``p`` solves path ``xg[p]`` against
``yg[p]``, both already scaled by ``rsqrt(h)``; the two paths may differ in
length. The function, shared by the twins and the kernels:

* statics ``g[a, b] = exp(-Σ_c (x_a,c - y_b,c)²)`` in the squared-difference
  form the port's K2 uses (``sigkernel_block3.py``), ``z = inc/64`` per
  coarse cell, ``A = 1 + z/2 + z²/12``, ``B = 1 - z²/12``;
* the fine-grid recurrence ``k[i+1, j+1] = (k[i+1, j] + k[i, j+1])·A -
  k[i, j]·B`` with the product by ``A`` fused into the subtraction, as K2
  and XLA round it;
* residuals at the JAX package's spacing: the fine node row at the top of
  every ``bpc = min(6, lx1)``-th band and of the last band (``ck [nslots,
  8·ly1+1, P]``) and the right-edge column ``rc [lx1, 8, P]``,
  ``rc[b, s] = k[8b+s, 8·ly1]``;
* fp32 backward (K4): the exact discrete adjoint. The twin keeps the whole
  grid; the kernel, as ``_bwd_rows_fast``, rebuilds each band's primal
  toward -j from the band's top row (carried from the band above,
  re-anchored at the checkpoints) and every row's right edge, band by band
  top down, beside the adjoint and the dz sums;
* bf16 backward (K6): ``_bwd_rows_fast_bf16``'s three first-order delta
  chains (ρ = ĝ[i] - ĝ[i+1], σ = k[i-1] - k[i], the dz sum) in bf16, re-
  anchored at the bf16-rounded checkpoints and at every row's fp32 right
  edge, as the JAX kernel re-anchors; statics, dz and the pull-back in fp32.

Layouts are pair-minor (``[L, C, P]``, ``[nslots, G1, P]``). All three
kernels run a lane group per pair (K6: per pair couple) with the fine rows
in the lanes' registers; :func:`fused_plan` lays out their launches. On CPU
tensors the wrappers run the twins; on CUDA tensors they launch
``csrc/sigkernel_fused.cu`` or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import load
from .sigkernel_block import (  # noqa: F401  (SPAN_CAP, SPAN_TEMPLATES: the plan's rule)
    SPAN_CAP, SPAN_TEMPLATES, THREADS, block_lanes, block_spans,
)

_LAM = 3
_M = 1 << _LAM  # 8 — fine rows per band / fine cols per coarse cell
_ZS = 1.0 / float(4**_LAM)  # dyadic grid scale on the increments
_I6 = 1.0 / 6.0
_I12 = 1.0 / 12.0

# csrc/sigkernel_fused.cu: the channel counts K4 has instantiations for (K6
# takes JAX's bf16 envelope, C ≤ 4 and ly1 ≤ 40), the most pairs (K6:
# couples) a lane group walks, and the SMs of an H100, over which the plan
# spreads a short list where it can
MAX_C = 8
MAX_C_BF16 = 4
MAX_LY1_BF16 = 40
TILE_ROWS = 8
SMS = 132


# ---------------------------------------------------------------------------
# Routing predicates, copied from the JAX package: they decide which route,
# and so which gradient, a call gets.
# ---------------------------------------------------------------------------


def pallas_supported(lx1: int, ly1: int, dyadic_order: int) -> bool:
    return dyadic_order == _LAM and ly1 <= 48


def _bands_per_ck(lx1: int) -> int:
    return min(6, lx1)


def _n_ck_slots(lx1: int, bpc: int) -> int:
    return -(-lx1 // bpc)


def _coef(z):
    return 1.0 + 0.5 * z + z * z * (1.0 / 12.0), 1.0 - z * z * (1.0 / 12.0)


def fused_supported(lx1: int, ly1: int, dyadic_order: int, n_channels: int,
                    static: str, h, grad_precision: str = "fp32") -> bool:
    if not (
        pallas_supported(lx1, ly1, dyadic_order)
        and static == "rbf"
        and h is not None
        and n_channels <= 8
    ):
        return False
    if grad_precision == "bf16":
        return ly1 <= 40 and n_channels <= 4
    return True


def fused_flops(P: int, Lx: int, Ly: int, C: int, part: str = "forward"):
    """``(fp32, bf16)`` operations of one call on ``P`` pairs, counting an
    ``exp`` as one and a fused multiply-add as two. Every part computes the
    static Gram (``Lx·Ly`` nodes at ``3C+2``) and the coarse coefficients
    (``lx1·ly1`` cells at 12). Per fine cell: the forward 4; the fp32
    backward 14 (the primal rebuilt from the checkpoints 4, the adjoint 5,
    the dz sums 5) plus ``12 + 8C`` per coarse cell for dz and the pull-back;
    the bf16 backward 12 bf16 operations (ρ 4, ĝ 1, σ 3, k 1, the dz term
    3) plus, in fp32, 2 per fine row per coarse cell for the dz sums and the
    same pull-back."""
    lx1, ly1 = Lx - 1, Ly - 1
    cells = (_M * lx1) * (_M * ly1)
    common = lx1 * ly1 * 12 + Lx * Ly * (3 * C + 2)
    if part == "forward":
        return float(P * (cells * 4 + common)), 0.0
    if part == "backward":
        return float(P * (cells * 14 + common + lx1 * ly1 * (12 + 8 * C))), 0.0
    if part == "bf16":
        fp32 = common + lx1 * ly1 * (2 * _M + 12 + 8 * C)
        return float(P * fp32), float(P * cells * 12)
    raise ValueError(f"unknown part {part!r}")


def fused_bytes(P: int, Lx: int, Ly: int, C: int, part: str = "forward") -> float:
    """Bytes a call must move, each input read once and each output written
    once: the forward reads the path tiles and writes k and the residuals;
    both backwards read the tiles, the checkpoints, the right edges and the
    cotangent and write both tiles' gradients."""
    lx1, ly1 = Lx - 1, Ly - 1
    tiles = P * (Lx + Ly) * C
    ck = P * _n_ck_slots(lx1, _bands_per_ck(lx1)) * (_M * ly1 + 1)
    rc = P * lx1 * _M
    if part == "forward":
        return 4.0 * (tiles + P + ck + rc)
    if part in ("backward", "bf16"):
        return 4.0 * (tiles + ck + rc + P + tiles)
    raise ValueError(f"unknown part {part!r}")


def residual_bytes(P: int, lx1: int, ly1: int) -> int:
    """Device bytes of the residuals ``ck`` and ``rc`` of ``P`` pairs."""
    return 4 * P * (_n_ck_slots(lx1, _bands_per_ck(lx1)) * (_M * ly1 + 1) + lx1 * _M)


def chunk_pair_bytes(lx1: int, ly1: int, C: int, device_type: str) -> int:
    """Memory a pair of a chunk holds: on the card its residuals, its gathered
    path tiles (pair-major and pair-minor) and their gradients; on the CPU
    the twin's stored grids (about eight ``(Gx+2)·(Gy+2)`` arrays)."""
    if device_type == "cuda":
        return residual_bytes(1, lx1, ly1) + 16 * (lx1 + ly1 + 2) * C + 16
    return 32 * (_M * lx1 + 2) * (_M * ly1 + 2)


# ---------------------------------------------------------------------------
# Plain PyTorch twins: vectorised over the pairs, the fine grid swept by
# anti-diagonals (each node's arithmetic is the row sweep's).
# ---------------------------------------------------------------------------


def pair_statics(xt: torch.Tensor, yt: torch.Tensor):
    """Static Gram ``g [Lx, Ly, P]`` and the coefficients ``z, A, B [lx1,
    ly1, P]`` of scaled path tiles ``xt [Lx, C, P]``, ``yt [Ly, C, P]``."""
    Lx, C, P = xt.shape
    Ly = yt.shape[0]
    d2 = torch.zeros(Lx, Ly, P, dtype=xt.dtype, device=xt.device)
    for c in range(C):
        d = xt[:, None, c] - yt[None, :, c]
        d2 += d * d
    g = torch.exp(-d2)
    del d2
    z = (((g[1:, 1:] - g[1:, :-1]) - g[:-1, 1:]) + g[:-1, :-1]) * _ZS
    A = 1.0 + 0.5 * z + z * z * _I12
    B = 1.0 - z * z * _I12
    return g, z, A, B


def _diag_cells(d: int, Gx: int, Gy: int, device):
    """Interior nodes ``(i, d-i)`` of anti-diagonal ``d`` (1 ≤ i ≤ Gx,
    1 ≤ j ≤ Gy)."""
    ii = torch.arange(max(1, d - Gy), min(Gx, d - 1) + 1, device=device)
    return ii, d - ii


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once: the fp32 product is exact in fp64."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def grid_forward(A: torch.Tensor, B: torch.Tensor, keep_grid: bool):
    """Fine-grid solve by anti-diagonals. Returns ``k[Gx, Gy] [P]`` and, with
    ``keep_grid``, the node grid ``[Gx+1, Gy+1, P]``."""
    Gx, Gy = _M * A.shape[0], _M * A.shape[1]
    P = A.shape[-1]
    ones = torch.ones(Gx + 1, P, dtype=A.dtype, device=A.device)
    grid = (torch.ones(Gx + 1, Gy + 1, P, dtype=A.dtype, device=A.device)
            if keep_grid else None)
    prev2, prev1 = ones, ones    # node values on diagonals d-2 and d-1, by i
    for d in range(2, Gx + Gy + 1):
        ii, jj = _diag_cells(d, Gx, Gy, A.device)
        ci, cj = (ii - 1) // _M, (jj - 1) // _M
        # k[i, j] = (k[i, j-1] + k[i-1, j])·A - k[i-1, j-1]·B, cell (i-1, j-1)
        val = _fma(prev1[ii] + prev1[ii - 1], A[ci, cj], -(prev2[ii - 1] * B[ci, cj]))
        cur = ones.clone()
        cur[ii] = val
        if keep_grid:
            grid[ii, jj] = val
        prev2, prev1 = prev1, cur
    return prev1[Gx], grid


def grid_adjoint(A: torch.Tensor, B: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """``λ[i, j] = ∂(seed·k[Gx, Gy])/∂k[i, j]`` on the nodes, by anti-diagonals
    from the top right:
    ``λ[i, j] = λ[i, j+1]·A(i-1, j) + λ[i+1, j]·A(i, j-1) - λ[i+1, j+1]·B(i, j)``
    (cell terms outside the grid are 0). Returns ``[Gx+1, Gy+1, P]``."""
    lx1, ly1 = A.shape[0], A.shape[1]
    Gx, Gy = _M * lx1, _M * ly1
    P = A.shape[-1]
    lam = torch.zeros(Gx + 2, Gy + 2, P, dtype=A.dtype, device=A.device)
    lam[Gx, Gy] = seed
    for d in range(Gx + Gy - 1, 1, -1):
        ii, jj = _diag_cells(d, Gx, Gy, A.device)
        cim, ci = (ii - 1) // _M, (ii // _M).clamp(max=lx1 - 1)
        cjm, cj = (jj - 1) // _M, (jj // _M).clamp(max=ly1 - 1)
        lam[ii, jj] = ((lam[ii, jj + 1] * A[cim, cj] + lam[ii + 1, jj] * A[ci, cjm])
                       - lam[ii + 1, jj + 1] * B[ci, cj])
    return lam[: Gx + 1, : Gy + 1]


def pull_back(xt, yt, g, dz):
    """Path-tile gradients ``(dx [Lx, C, P], dy [Ly, C, P])`` from ``dz``
    (the cotangent of the scaled increments, ``[lx1, ly1, P]``), through the
    double difference and the RBF statics."""
    Lx, Ly, P = g.shape
    dinc = dz * _ZS
    # dg[a, b] = dinc[a-1, b-1] - dinc[a-1, b] - dinc[a, b-1] + dinc[a, b]
    dp = torch.zeros(Lx + 1, Ly + 1, P, dtype=g.dtype, device=g.device)
    dp[1:Lx, 1:Ly] = dinc
    dg = ((dp[:-1, :-1] - dp[:-1, 1:]) - dp[1:, :-1]) + dp[1:, 1:]
    dd2 = -g * dg                                     # ∂/∂d², [Lx, Ly, P]
    dx = 2.0 * (xt * dd2.sum(1)[:, None] - torch.einsum("abP,bcP->acP", dd2, yt))
    dy = 2.0 * (yt * dd2.sum(0)[:, None] - torch.einsum("abP,acP->bcP", dd2, xt))
    return dx, dy


def fused_pairs_plain(xt: torch.Tensor, yt: torch.Tensor, seed: torch.Tensor):
    """``(k [P], dx [Lx, C, P], dy [Ly, C, P])``: the values and the exact
    fp32 adjoint of ``seed·k`` on the stored grid (about ``6·Gx·Gy`` values
    per pair)."""
    lx1, ly1 = xt.shape[0] - 1, yt.shape[0] - 1
    g, z, A, B = pair_statics(xt, yt)
    kval, k = grid_forward(A, B, keep_grid=True)
    lam = grid_adjoint(A, B, seed)

    # dz per coarse cell: Σ over its 8×8 fine cells of λ[i+1, j+1]·∂k/∂z,
    # ∂k[i+1, j+1]/∂z = (k[i+1, j] + k[i, j+1])·(½ + z/6) + k[i, j]·z/6
    P = xt.shape[-1]
    blk = (lx1, _M, ly1, _M, P)
    lt = lam[1:, 1:].reshape(blk)
    s1 = (lt * (k[1:, :-1] + k[:-1, 1:]).reshape(blk)).sum((1, 3))
    s2 = (lt * k[:-1, :-1].reshape(blk)).sum((1, 3))
    del k, lam, lt
    dz = (0.5 + z * _I6) * s1 + (z * _I6) * s2
    dx, dy = pull_back(xt, yt, g, dz)
    return kval, dx, dy


def fused_forward_plain(xt: torch.Tensor, yt: torch.Tensor, residuals: bool):
    """The twin of K4's forward: ``(k,)`` or ``(k, ck, rc)``."""
    lx1 = xt.shape[0] - 1
    A, B = pair_statics(xt, yt)[2:]
    kval, grid = grid_forward(A, B, keep_grid=residuals)
    if not residuals:
        return (kval,)
    bpc = _bands_per_ck(lx1)
    tops = [_M * (b + 1) for b in range(lx1) if (b + 1) % bpc == 0 or b == lx1 - 1]
    ck = grid[tops].contiguous()                                  # [nslots, G1, P]
    rc = grid[:-1, -1].reshape(lx1, _M, -1).contiguous()          # [lx1, 8, P]
    return kval, ck, rc


def fused_backward_plain(xt: torch.Tensor, yt: torch.Tensor, gout: torch.Tensor):
    """The twin of K4's backward: ``(dx, dy)`` for cotangent ``gout [P]``."""
    return fused_pairs_plain(xt, yt, gout)[1:]


def bf16_dz(xt: torch.Tensor, yt: torch.Tensor, ck: torch.Tensor, rc: torch.Tensor,
            gout: torch.Tensor):
    """K6's twin up to its pull-back: ``(g [Lx, Ly, P], dz [lx1, ly1, P])``,
    the static Gram and the cotangent of the scaled increments, by
    ``_bwd_rows_fast_bf16``'s delta chains in torch bf16 ops, one rounding
    per operation, in the JAX kernel's order (rows top down, fine columns
    right to left); statics and dz in fp32."""
    bf = torch.bfloat16
    Lx, C, P = xt.shape
    Ly = yt.shape[0]
    lx1, ly1 = Lx - 1, Ly - 1
    gy = _M * ly1
    bpc = _bands_per_ck(lx1)
    g, z = pair_statics(xt, yt)[:2]
    zh_all = (z * 0.5).to(bf)
    zero = torch.zeros(P, dtype=bf, device=xt.device)
    kbuf = torch.ones(2, gy + 1, P, dtype=bf, device=xt.device)
    gbuf = torch.zeros(2, gy + 2, P, dtype=bf, device=xt.device)
    seed = gout.to(bf)
    dz = torch.zeros(lx1, ly1, P, dtype=xt.dtype, device=xt.device)
    for r in range(lx1):
        b = lx1 - 1 - r
        zh = zh_all[b]
        zhu = zh_all[b + 1] if r > 0 else torch.zeros_like(zh)
        if (b + 1) % bpc == 0 or b == lx1 - 1:
            kbuf[0] = ck[b // bpc].to(bf)
        for t in range(_M):
            par, top = t & 1, t == 0
            kcur, knew = t & 1, (t + 1) & 1
            kr0 = rc[b, _M - 1 - t].to(bf)        # k[i-1, gy], the fp32 anchor
            sig = kr0 - kbuf[kcur, gy]
            kbuf[knew, gy] = kr0
            rho = zero
            for cc in range(ly1 - 1, -1, -1):
                zc = zh[cc]
                zu = zhu[cc] if top else zc
                zr = zh[min(cc + 1, ly1 - 1)]
                kc = kbuf[kcur, cc * _M: cc * _M + _M + 1]          # row i
                gup = gbuf[1 - par, cc * _M + 1: cc * _M + _M + 2]  # row i+1
                s1 = None
                for tt in range(_M - 1, -1, -1):
                    z1 = zr if tt == _M - 1 else zc
                    rho = (rho + z1 * gup[tt + 1]) + zu * gup[tt]
                    if top and tt == _M - 1 and r == 0 and cc == ly1 - 1:
                        rho = rho + seed
                    gg = gup[tt] + rho
                    gbuf[par, cc * _M + 1 + tt] = gg
                    s = kc[tt] + kc[tt + 1]
                    m1 = s + sig
                    s1 = gg * m1 if s1 is None else s1 + gg * m1
                    sig = sig + zc * s
                    if tt == 0 and cc == 0:
                        sig = zero                 # the left boundary is one
                    kbuf[knew, cc * _M + tt] = kc[tt] + sig
                val = s1.to(xt.dtype) * 0.5
                dz[b, cc] = val if t == 0 else dz[b, cc] + val
    return g, dz


def fused_backward_bf16_plain(xt: torch.Tensor, yt: torch.Tensor, ck: torch.Tensor,
                              rc: torch.Tensor, gout: torch.Tensor):
    """The twin of K6: :func:`bf16_dz` and the fp32 pull-back. Returns
    ``(dx, dy)``."""
    return pull_back(xt, yt, *bf16_dz(xt, yt, ck, rc, gout))


# ---------------------------------------------------------------------------
# The lane kernels' plan: lanes, spans, runs, tiles and blocks.
# ---------------------------------------------------------------------------

# the kernels a plan lays out, by their index in csrc sigkernel_fused_resident
_PARTS = {"forward": 0, "bf16": 1, "backward": 2}


def fused_lanes(ly1: int) -> tuple[int, int]:
    """``(g, span)``: the lanes of a pair (K6: of a pair couple) and the span
    template, K5's rule (``sigkernel_tiled.tiled_lanes``) on the ly1 coarse
    columns: the fewest lanes, a power of two, that leave no lane more than
    :data:`SPAN_CAP` columns; 8 at ly1 = 39-40, 16 at 48, 1 up to 5."""
    return block_lanes(ly1 + 1)


def fused_spans(ly1: int, g: int) -> list[int]:
    """Coarse columns of each lane: lane t holds ``[t·ly1/g, (t+1)·ly1/g)``."""
    return block_spans(ly1 + 1, g)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sector_share(P: int, rows: int, piece: int) -> float:
    """Share of the bytes of ``rows`` pair-minor rows of ``P`` floats that a
    warp's accesses move in whole, aligned 32-byte sectors, when one access
    covers ``piece`` adjacent pairs from a multiple of ``piece``."""
    if rows == 0:
        return 1.0
    starts = torch.arange(0, P, piece, dtype=torch.int64)
    lens = torch.clamp(P - starts, max=piece)
    counts = torch.bincount((torch.arange(rows, dtype=torch.int64) * P) % 8, minlength=8)
    whole = 0
    for off in range(8):          # a row's first float, modulo a sector's 8
        if counts[off]:
            a = 4 * (off + starts)
            e = a + 4 * lens
            sectors = (e // 32 - (a + 31) // 32).clamp(min=0).sum().item()
            whole += int(counts[off]) * 32 * sectors
    return whole / (4.0 * rows * P)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How K4's forward (``part`` "forward"), K4's backward ("backward") or
    K6 ("bf16") lays out one call on ``P`` pairs: ``g`` lanes a pair (K6: a
    pair couple), each holding a span of whole coarse columns (``spans``, at
    most ``span``, the template); tiles of ``tile_rows`` × ``tile_cols``
    pairs (K6: couples; a group walks ``tile_rows`` of them as one pipeline
    of ``steps`` steps), ``tiles`` of them over ``blocks`` persistent
    blocks (those resident on the card at once, ``resident``, where known;
    else one a tile); ``smem_bytes`` a
    block's shared memory; ``scratch_bytes`` device scratch per thread
    (none); ``traffic_bytes`` the device-memory traffic of a launch (the
    forward with and without residuals); ``piece`` the adjacent pairs one
    warp access of a residual column covers (lane position t's groups in a
    warp), over ``residual_rows`` pair-minor rows of ``pairs`` floats."""
    part: str
    pairs: int
    g: int
    span: int
    spans: tuple
    tile_rows: int
    tile_cols: int
    pairs_per_tile: int
    tiles: int
    blocks: int
    steps: int
    smem_bytes: int
    scratch_bytes: int
    traffic_bytes: dict
    piece: int
    residual_rows: int
    resident: int | None

    @property
    def passes(self) -> int:
        """Tiles the busiest block takes: the persistent loop's passes."""
        return _cdiv(self.tiles, self.blocks)

    @property
    def sector_share(self) -> float:
        """The share of the residual stores (forward) or loads (backwards)
        that a warp's access moves in whole 32-byte sectors."""
        return _sector_share(self.pairs, self.residual_rows, self.piece)

    def report(self) -> dict:
        """The plan's fields and properties, for a JSON row."""
        return dict(dataclasses.asdict(self), passes=self.passes,
                    sector_share=self.sector_share)


def fused_plan(P: int, lx1: int, ly1: int, C: int, part: str,
               resident: int | None = None, sms: int = SMS) -> FusedPlan:
    """The plan of K4's forward (``part="forward"``), K4's backward
    (``"backward"``) or K6 (``"bf16"``) for ``P`` pairs of ``lx1 × ly1``
    coarse cells and ``C`` channels.

    A group walks ``tile_rows`` pairs (K6: couples (2q, 2q+1)): the most of
    8, 4, 2, 1 that still gives ``sms`` tiles, so that a short list spreads
    over as many SMs as it can (a run of one pays the pipeline's fill, g-1
    of its lx1 + g-1 steps). ``smem_bytes`` (csrc ``fwd_smem_floats``,
    ``bwd_thread_floats``, ``bf16_thread_floats``): per thread the
    forward's y points of its span, ``(span+1)·C`` floats; the fp32
    backward's y points and their column-path gradients, ``(span+1)·C``
    floats each, and the stage its next unit's inputs are copied into (the
    anchor row ``8·span``, the checkpoint's last column 1, the right edges
    8, x rows ``2C``); K6's the same for both pairs of a couple (``2·(span
    +1)·C`` floats each, a stage of ``16·span + 2 + 16 + 4C``).
    ``traffic_bytes``: the paths read once (the group's lanes share x
    through L1), k, the residuals, the cotangent and the gradients once
    each; no fine row, adjoint row or scratch row goes to device memory."""
    if part not in _PARTS:
        raise ValueError(f"unknown part {part!r}")
    g, span = fused_lanes(ly1)
    tc = THREADS // g
    per = 2 if part == "bf16" else 1
    units = _cdiv(P, per)
    rows = next((r for r in (TILE_ROWS, 4, 2) if _cdiv(units, r * tc) >= sms), 1)
    tiles = _cdiv(units, rows * tc)
    blocks = tiles if resident is None else max(1, min(tiles, resident))
    nres = _n_ck_slots(lx1, _bands_per_ck(lx1)) * (_M * ly1 + 1) + lx1 * _M
    if part == "forward":
        smem = 4 * THREADS * (span + 1) * C
        traffic = {"forward": fused_bytes(P, lx1 + 1, ly1 + 1, C),
                   "values": 4.0 * (P * (lx1 + ly1 + 2) * C + P)}
    elif part == "backward":
        smem = 4 * THREADS * (2 * (span + 1) * C + 8 * span + 9 + 2 * C)
        traffic = {"backward": fused_bytes(P, lx1 + 1, ly1 + 1, C, "backward")}
    else:
        smem = 4 * THREADS * (4 * (span + 1) * C + 16 * span + 18 + 4 * C)
        traffic = {"bf16": fused_bytes(P, lx1 + 1, ly1 + 1, C, "bf16")}
    return FusedPlan(
        part=part, pairs=P, g=g, span=span, spans=tuple(fused_spans(ly1, g)),
        tile_rows=rows, tile_cols=tc, pairs_per_tile=rows * tc * per, tiles=tiles,
        blocks=blocks, steps=rows * lx1 + g - 1, smem_bytes=smem, scratch_bytes=0,
        traffic_bytes=traffic, piece=per * (32 // g), residual_rows=nres, resident=resident)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def kernel_supported(lx1: int, ly1: int, C: int) -> bool:
    """Shapes ``csrc/sigkernel_fused.cu`` takes: JAX's fused envelope (ly1 ≤
    48, C ≤ 8), any lx1. Its bands stream, so lx1 bounds only the
    residuals' size, which the caller's chunk plan accounts for."""
    return lx1 >= 1 and 1 <= ly1 <= 48 and 1 <= C <= MAX_C


def _lib():
    lib = load("sigkernel_fused")
    lib.sigkernel_fused_resident.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.sigkernel_fused_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    for fn in (lib.sigkernel_fused_bwd, lib.sigkernel_fused_bwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for fn in (lib.sigkernel_fused_resident, lib.sigkernel_fused_fwd,
               lib.sigkernel_fused_bwd, lib.sigkernel_fused_bwd_bf16):
        fn.restype = ctypes.c_int
    return lib


def _check(xt: torch.Tensor, yt: torch.Tensor, what: str):
    if xt.device.type != "cuda" or yt.device != xt.device:
        raise ValueError(f"{what}: unsupported devices {xt.device}, {yt.device}")
    for t in (xt, yt):
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous fp32 [L, C, P] path tiles")
    lx1, C, P = xt.shape[0] - 1, xt.shape[1], xt.shape[2]
    ly1 = yt.shape[0] - 1
    if yt.shape[1:] != (C, P):
        raise ValueError(f"{what}: tiles {tuple(xt.shape)} and {tuple(yt.shape)} disagree")
    if not kernel_supported(lx1, ly1, C):
        route = ("the solve on given increments, sigkernel_tiled.pair_values"
                 if C > MAX_C else "the wavefront, sigkernel.solve_goursat_pde")
        raise NotImplementedError(
            f"{lx1 + 1}x{ly1 + 1}-node paths with {C} channels are outside the "
            f"fused λ=3 kernels' envelope (ly1 ≤ 48, C ≤ 8); they take {route}"
        )
    return lx1, ly1, C, P


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def resident_blocks(span: int, C: int, part: str, device_index: int) -> int:
    """Blocks of K4's forward, K4's backward or K6 (``part``) with span
    template ``span`` resident on the card at once: the occupancy query's
    blocks an SM (with the plan's shared memory) times the SMs."""
    per_sm = ctypes.c_int(0)
    err = _lib().sigkernel_fused_resident(span, C, _PARTS[part], ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"fused {part} occupancy query failed: cudaError {err}")
    return per_sm.value * torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_plan(P: int, lx1: int, ly1: int, C: int, part: str, device) -> FusedPlan:
    """:func:`fused_plan` for a launch on ``device``: its SMs and the
    kernel's resident blocks there."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    span = fused_lanes(ly1)[1]
    return fused_plan(P, lx1, ly1, C, part, resident=resident_blocks(span, C, part, index),
                      sms=torch.cuda.get_device_properties(index).multi_processor_count)


def fused_forward(xt: torch.Tensor, yt: torch.Tensor, residuals: bool):
    """K4's forward on scaled path tiles ``xt [Lx, C, P]``, ``yt [Ly, C, P]``:
    ``(k,)``, or ``(k, ck, rc)`` with the residuals. CPU tensors take the
    twin; CUDA tensors launch the kernel and add one to
    ``fused_forward.launches``."""
    if xt.device.type == "cpu":
        return fused_forward_plain(xt, yt, residuals)
    lx1, ly1, C, P = _check(xt, yt, "K4")
    plan = launch_plan(P, lx1, ly1, C, "forward", xt.device)
    bpc = _bands_per_ck(lx1)
    k = torch.empty(P, dtype=xt.dtype, device=xt.device)
    ck = rc = None
    if residuals:
        ck = torch.empty(_n_ck_slots(lx1, bpc), _M * ly1 + 1, P, dtype=xt.dtype,
                         device=xt.device)
        rc = torch.empty(lx1, _M, P, dtype=xt.dtype, device=xt.device)
    err = _lib().sigkernel_fused_fwd(
        xt.data_ptr(), yt.data_ptr(), k.data_ptr(), ck.data_ptr() if residuals else None,
        rc.data_ptr() if residuals else None, P, lx1 + 1, ly1 + 1, C, plan.g, plan.span,
        bpc, plan.tile_rows, plan.tiles, plan.blocks, _stream(xt))
    if err != 0:
        raise RuntimeError(f"K4 forward launch failed: cudaError {err}")
    fused_forward.launches += 1
    return (k, ck, rc) if residuals else (k,)


def _backward(xt, yt, ck, rc, gout, bf16: bool):
    lx1, ly1, C, P = _check(xt, yt, "K6" if bf16 else "K4")
    if bf16 and (C > MAX_C_BF16 or ly1 > MAX_LY1_BF16):
        raise ValueError(f"K6 takes C ≤ {MAX_C_BF16} and ly1 ≤ {MAX_LY1_BF16} (the JAX "
                         "package's bf16 envelope); other paths take K4's fp32 backward, "
                         "as SignatureKernel routes them")
    if gout.shape != (P,) or gout.dtype != torch.float32 or not gout.is_contiguous():
        raise ValueError("the cotangent must be a contiguous fp32 [P] tensor")
    bpc = _bands_per_ck(lx1)
    residuals = {"ck": (ck, (_n_ck_slots(lx1, bpc), _M * ly1 + 1, P)), "rc": (rc, (lx1, _M, P))}
    for name, (t, shape) in residuals.items():
        if (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != xt.device):
            raise ValueError(f"{name} must be K4's forward residual, fp32 {shape}")
    dx = torch.empty_like(xt)
    dy = torch.empty_like(yt)
    plan = launch_plan(P, lx1, ly1, C, "bf16" if bf16 else "backward", xt.device)
    lib = _lib()
    launch = lib.sigkernel_fused_bwd_bf16 if bf16 else lib.sigkernel_fused_bwd
    err = launch(xt.data_ptr(), yt.data_ptr(), ck.data_ptr(), rc.data_ptr(), gout.data_ptr(),
                 dx.data_ptr(), dy.data_ptr(), P, lx1 + 1, ly1 + 1, C, plan.g, plan.span, bpc,
                 plan.tile_rows, plan.tiles, plan.blocks, _stream(xt))
    if err != 0:
        raise RuntimeError(f"{'K6' if bf16 else 'K4 backward'} launch failed: "
                           f"cudaError {err}")
    return dx, dy


def fused_backward(xt, yt, ck, rc, gout):
    """K4's fp32 backward: ``(dx [Lx, C, P], dy [Ly, C, P])``, the gradients
    of ``Σ gout·k`` with respect to the scaled tiles, from the forward's
    residuals ``ck`` and ``rc``. CPU tensors take the twin (which ignores
    the residuals); CUDA tensors launch the kernel (a lane group per pair)
    and add one to ``fused_backward.launches``."""
    if xt.device.type == "cpu":
        return fused_backward_plain(xt, yt, gout)
    out = _backward(xt, yt, ck, rc, gout, bf16=False)
    fused_backward.launches += 1
    return out


def fused_backward_bf16(xt, yt, ck, rc, gout):
    """K6: as :func:`fused_backward`, by the bf16 delta-form chains (a lane
    group per pair couple in bf16x2, C ≤ 4, ly1 ≤ 40); counted in
    ``fused_backward_bf16.launches``."""
    if xt.device.type == "cpu":
        return fused_backward_bf16_plain(xt, yt, ck, rc, gout)
    out = _backward(xt, yt, ck, rc, gout, bf16=True)
    fused_backward_bf16.launches += 1
    return out


fused_forward.launches = 0
fused_backward.launches = 0
fused_backward_bf16.launches = 0


class _FusedPairGram(torch.autograd.Function):
    """``k [P]`` of pre-scaled gathered paths ``xg [P, Lx, C]``, ``yg [P, Ly,
    C]``; the backward runs K4's fp32 adjoint or K6."""

    @staticmethod
    def forward(ctx, xg, yg, grad_precision):
        xt = xg.permute(1, 2, 0).contiguous()
        yt = yg.permute(1, 2, 0).contiguous()
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return fused_forward(xt, yt, residuals=False)[0]
        k, ck, rc = fused_forward(xt, yt, residuals=True)
        ctx.save_for_backward(xt, yt, ck, rc)
        ctx.grad_precision = grad_precision
        return k

    @staticmethod
    def backward(ctx, gout):
        xt, yt, ck, rc = ctx.saved_tensors
        backward = fused_backward_bf16 if ctx.grad_precision == "bf16" else fused_backward
        dx, dy = backward(xt, yt, ck, rc, gout.contiguous())
        return dx.permute(2, 0, 1), dy.permute(2, 0, 1), None


def pair_gram_fused(X: torch.Tensor, Y: torch.Tensor, ix: torch.Tensor,
                    iy: torch.Tensor, h, grad_precision: str = "fp32") -> torch.Tensor:
    """Signature-kernel values ``k [P]`` of the pairs ``(X[ix], Y[iy])``,
    differentiable with respect to X, Y and h: the ``rsqrt(h)`` pre-scale is
    a torch op outside the kernels (``‖(x−y)/√h‖² ≡ ‖x−y‖²/h``), as in
    ``pallas_pair_gram_fused``."""
    scale = torch.rsqrt(torch.as_tensor(h, dtype=X.dtype, device=X.device))
    return _FusedPairGram.apply((X * scale)[ix], (Y * scale)[iy], grad_precision)
