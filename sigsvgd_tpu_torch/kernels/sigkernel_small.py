"""λ=0 pair-list signature kernel with the RBF statics inside the kernels:
K7 (forward, with or without residuals; fp32 backward) and its plain twins.

Port of ``sigsvgd_tpu/kernels/pallas_sigkernel_small.py``
(``pallas_pair_gram_small``). Pair ``p`` solves path ``xt[:, :, p]``
against ``yt[:, :, p]``, both already scaled by ``rsqrt(h)``; the two paths
may differ in length. The function, shared by the twins and the kernels:

* static nodes in ``_g_row``'s expand form ``g = exp(-max(‖x‖² + ‖y‖² −
  2⟨x, y⟩, 0))``, each sum over the channels taken in channel order;
* per cell ``z = gu[j+1] − gu[j] − gl[j+1] + gl[j]`` (rows i+1 and i),
  ``a = 1 + z(½ + z/12)``, ``b = 1 − z²/12`` and the order-0 update
  ``k[i+1, j+1] = (k[i+1, j] + k[i, j+1])·a − k[i, j]·b``;
* the only residual, the per-cell factor ``fac = ∂k[i+1, j+1]/∂z =
  (k[i+1, j] + k[i, j+1])(½ + z/6) + k[i, j]·z/6``, ``[lx1, ly1]`` a pair;
* the backward: adjoint rows top-down (``dz = λ[i+1, j+1]·fac``, no primal
  reconstruction) and the pull-back of ``dz`` through the statics into
  both tiles.

The path tiles are pair-minor (``[L][C][P]``), ``fac`` is ``[lx1, ly1,
P]``. On CPU tensors the wrappers run the twins; on CUDA tensors they
launch ``csrc/sigkernel_small.cu`` (a lane group per pair, laid out by
:func:`small_plan`) or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import load
from .sigkernel_fused import _sector_share

_I6 = 1.0 / 6.0
_I12 = 1.0 / 12.0

# csrc/sigkernel_small.cu: its envelope, a block's threads and the span
# templates; the most pairs a lane group walks and the SMs a plan assumes
# off the card
MAX_LY = 64
MAX_C = 8
THREADS = 128
SPAN_TEMPLATES = (3, 5)
TILE_ROWS = 8
SMS = 132


def small_supported(lx1: int, ly1: int, dyadic_order: int, n_channels: int,
                    static: str, h) -> bool:
    """Shapes the JAX package's λ=0 pair-list route takes (copied: it decides
    the route). lx1 is unbounded; ``(10 + 3C)·ly`` bounds the TPU kernel's
    scratch."""
    ly = ly1 + 1
    vmem = (10 + 3 * n_channels) * ly * 16 * 128 * 4
    return (
        dyadic_order == 0
        and ly1 <= 63
        and n_channels <= 8
        and vmem <= 12 * 2**20
        and static == "rbf"
        and h is not None
    )


def kernel_supported(lx1: int, ly1: int, C: int) -> bool:
    """Shapes ``csrc/sigkernel_small.cu`` takes: ly ≤ 64 (a pair's K, static
    and adjoint rows spread over at most 32 lanes' registers), C ≤ 8, any
    lx1."""
    return lx1 >= 1 and 1 <= ly1 <= MAX_LY - 1 and 1 <= C <= MAX_C


def _statics_flops(Lx: int, Ly: int, C: int) -> int:
    """Per pair: every node's cross term, ``2·⟨x, y⟩``, the sums, the clamp
    and the exp (``2C + 4``), plus each point's squared norm."""
    return Lx * Ly * (2 * C + 4) + (Lx + Ly) * (2 * C - 1)


def small_flops(P: int, Lx: int, Ly: int, C: int, part: str = "forward") -> float:
    """fp32 operations of one call on ``P`` pairs, an ``exp`` counted as one
    and a fused multiply-add as two, each value once. Per cell: the forward
    14 (z 3, a 4, b 3, the update 4), the residual 6 more; the backward 20
    (z, a, b 10, the adjoint chain 5, dz 1, its four dg terms 4) and per node
    ``2 + 6C`` for the pull-back. Each part forms the statics once."""
    cells = (Lx - 1) * (Ly - 1)
    st = _statics_flops(Lx, Ly, C)
    if part == "forward":
        return float(P * (st + 14 * cells))
    if part == "residuals":
        return float(P * (st + 20 * cells))
    if part == "backward":
        return float(P * (st + 20 * cells + Lx * Ly * (2 + 6 * C)))
    raise ValueError(f"unknown part {part!r}")


def small_bytes(P: int, Lx: int, Ly: int, C: int, part: str = "forward") -> float:
    """Bytes a call must move, each input read once and each output written
    once: the forward reads both tiles and writes k (and ``fac``); the
    backward reads the tiles, ``fac`` and the cotangent and writes both
    tiles' gradients."""
    tiles = P * (Lx + Ly) * C
    fac = P * (Lx - 1) * (Ly - 1)
    if part == "forward":
        return 4.0 * (tiles + P)
    if part == "residuals":
        return 4.0 * (tiles + P + fac)
    if part == "backward":
        return 4.0 * (tiles + fac + P + tiles)
    raise ValueError(f"unknown part {part!r}")


def residual_bytes(P: int, lx1: int, ly1: int) -> int:
    """Device bytes of the residual ``fac`` of ``P`` pairs."""
    return 4 * P * lx1 * ly1


def chunk_pair_bytes(lx1: int, ly1: int, C: int) -> int:
    """Memory a pair of a chunk holds: its residual, its gathered path tiles
    (pair-major and pair-minor) and their gradients, and on the CPU the
    twin's dozen node rows."""
    return residual_bytes(1, lx1, ly1) + 16 * (lx1 + ly1 + 2) * C + 48 * (ly1 + 1)


# ---------------------------------------------------------------------------
# Plain PyTorch twins: vectorised over the pairs, the grid walked row by row
# in the JAX kernel's order.
# ---------------------------------------------------------------------------


def _sq_norms(t: torch.Tensor) -> torch.Tensor:
    """``Σ_c t[:, c]²`` summed in channel order: ``[L, C, P] → [L, P]``."""
    s = t[:, 0] * t[:, 0]
    for c in range(1, t.shape[1]):
        s = s + t[:, c] * t[:, c]
    return s


def _g_row(xi: torch.Tensor, yt: torch.Tensor, yn: torch.Tensor) -> torch.Tensor:
    """Static row ``[Ly, P]`` of the path point ``xi [C, P]`` against every
    point of ``yt [Ly, C, P]`` (``yn`` their squared norms)."""
    xn = xi[0] * xi[0]
    cross = xi[0] * yt[:, 0]
    for c in range(1, xi.shape[0]):
        xn = xn + xi[c] * xi[c]
        cross = cross + xi[c] * yt[:, c]
    return torch.exp(-torch.clamp_min((xn + yn) - 2.0 * cross, 0.0))


def _coefs(gu: torch.Tensor, gl: torch.Tensor):
    z = ((gu[1:] - gu[:-1]) - gl[1:]) + gl[:-1]
    return z, 1.0 + z * (0.5 + z * _I12), 1.0 - z * z * _I12


def small_forward_plain(xt: torch.Tensor, yt: torch.Tensor, residuals: bool):
    """The twin of K7's forward: ``(k [P],)`` or ``(k, fac [lx1, ly1, P])``."""
    Lx, _, P = xt.shape
    Ly = yt.shape[0]
    yn = _sq_norms(yt)
    ones = torch.ones(P, dtype=xt.dtype, device=xt.device)
    krow = [ones] * Ly
    fac = (torch.empty(Lx - 1, Ly - 1, P, dtype=xt.dtype, device=xt.device)
           if residuals else None)
    gl = _g_row(xt[0], yt, yn)
    kl = ones
    for i in range(Lx - 1):
        gu = _g_row(xt[i + 1], yt, yn)
        z, a, b = _coefs(gu, gl)
        kl, prev = ones, krow[0]
        for j in range(Ly - 1):
            old = krow[j + 1]
            s = kl + old
            kn = s * a[j] - prev * b[j]
            if residuals:
                fac[i, j] = s * (0.5 + z[j] * _I6) + prev * (z[j] * _I6)
            krow[j + 1] = kn
            prev, kl = old, kn
        gl = gu
    return (kl, fac) if residuals else (kl,)


def small_backward_plain(xt: torch.Tensor, yt: torch.Tensor, fac: torch.Tensor,
                         gout: torch.Tensor):
    """The twin of K7's backward: ``(dxt [Lx, C, P], dyt [Ly, C, P])``, the
    gradients of ``Σ_p gout[p]·k[p]``, in ``_small_bwd_kernel``'s order: the
    adjoint row i+1 completed right to left while row i accumulates, the dg
    rows, then the pull-back of dg row i+1 (``w = dg·g``)."""
    Lx, C, P = xt.shape
    Ly = yt.shape[0]
    lx1, ly1 = Lx - 1, Ly - 1
    yn = _sq_norms(yt)
    lamc = torch.zeros(Ly, P, dtype=xt.dtype, device=xt.device)
    lamc[ly1] = gout
    lamn = torch.zeros_like(lamc)
    dgu, dgc = torch.zeros_like(lamc), torch.zeros_like(lamc)
    dyt = torch.zeros_like(yt)
    dxt = torch.empty_like(xt)

    def pull_back(dg, g, xi):
        w = dg * g                                   # [Ly, P]
        sw = w.sum(0)
        dxi = torch.empty_like(xi)
        for c in range(C):
            dxi[c] = 2.0 * ((w * yt[:, c]).sum(0) - xi[c] * sw)
            dyt[:, c] -= 2.0 * w * (yt[:, c] - xi[c])
        return dxi

    gu = _g_row(xt[lx1], yt, yn)
    for i in range(lx1 - 1, -1, -1):
        gl = _g_row(xt[i], yt, yn)
        z, a, b = _coefs(gu, gl)
        lam_right = lamc[ly1].clone()
        for j in range(ly1 - 1, -1, -1):
            lam = lam_right
            t = lam * a[j]
            lam_right = lamc[j] + t
            lamc[j] = lam_right
            lamn[j + 1] += t
            lamn[j] -= lam * b[j]
            dz = lam * fac[i, j]
            dgu[j + 1] += dz
            dgu[j] -= dz
            dgc[j + 1] -= dz
            dgc[j] += dz
        dxt[i + 1] = pull_back(dgu, gu, xt[i + 1])
        dgu, dgc = dgc, torch.zeros_like(dgc)
        lamc, lamn = lamn, torch.zeros_like(lamn)
        gu = gl
    dxt[0] = pull_back(dgu, gu, xt[0])
    return dxt, dyt


# ---------------------------------------------------------------------------
# The lane schedule's plan.
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def span_cap(C: int) -> int:
    """Columns a lane holds at most: 5 up to 4 channels, 3 beyond, where
    each column's y point and its column-path gradient take 2C registers."""
    return 5 if C <= 4 else 3


def small_lanes(ly1: int, C: int) -> tuple[int, int]:
    """``(g, span)``: the lanes of a pair, the fewest (a power of two, at
    most 32) that leave no lane more than :func:`span_cap` of the ly1
    columns (8 at ly1 = 33-40 and 16 at 41-63 up to C = 4; 1 at ly1 ≤ 5),
    and the span template (3 or 5) that holds the widest span. Every lane
    holds that many columns of the grid padded by ``g·span - ly1`` virtual
    columns (csrc: the forward's on the left, their y point point 0; the
    backward's on the right, point ly1; z = 0 in every virtual cell, so k
    stays 1 and the adjoint 0 there exactly)."""
    g = 1
    while _cdiv(ly1, g) > span_cap(C):
        g *= 2
    return g, next(t for t in SPAN_TEMPLATES if _cdiv(ly1, g) <= t)


def small_spans(ly1: int, C: int) -> list[int]:
    """Real columns of each lane in the forward: lane t holds ``[t·span -
    pad, (t+1)·span - pad)``, the negative ones virtual."""
    g, span = small_lanes(ly1, C)
    pad = g * span - ly1
    return [max(0, (t + 1) * span - pad) - max(0, t * span - pad) for t in range(g)]


def stage_stride(g: int) -> int:
    """Floats between two rows of a block's residual stage (csrc
    ``stage_stride``): the block's ``THREADS/g`` pairs and 4 more, so a row
    starts 16-byte aligned and, at 8 lanes a pair, a warp's lanes write 32
    banks."""
    return THREADS // g + 4


# the kernels a plan lays out, by their index in csrc sigkernel_small_resident
PARTS = {"forward": 0, "residuals": 1, "backward": 2}


@dataclasses.dataclass(frozen=True)
class SmallPlan:
    """How K7 lays out one call on ``pairs`` pairs of ``lx1 × ly1`` cells
    and ``C`` channels: ``g`` lanes a pair, each holding ``span`` columns
    of the grid padded by ``pad`` virtual ones (``spans``: the real columns
    of each lane in the forward); tiles of
    ``tile_rows`` × ``tile_cols`` pairs (a group walks ``tile_rows`` of
    them as one pipeline of ``steps`` steps), ``tiles`` of them over
    ``blocks`` persistent blocks of ``THREADS`` (``threads`` in all; the
    blocks resident on the card at once, ``resident``, where known, else
    one a tile); ``stage_bytes`` one of a block's residual stages (the
    forward with the residual alternates two, the backward cycles three;
    values only none), ``traffic_bytes`` the device-memory traffic of each
    launch (values only, with the residual, the backward); no scratch."""
    pairs: int
    lx1: int
    ly1: int
    C: int
    g: int
    span: int
    pad: int
    spans: tuple
    tile_rows: int
    tile_cols: int
    pairs_per_tile: int
    tiles: int
    blocks: int
    threads: int
    steps: int
    stage_bytes: int
    traffic_bytes: dict
    resident: int | None

    @property
    def passes(self) -> int:
        """Tiles the busiest block takes: the persistent loop's passes."""
        return _cdiv(self.tiles, self.blocks)

    @property
    def sector_share(self) -> float:
        """The share of the residual's stores (forward) and loads (backward)
        that a warp moves in whole 32-byte sectors: a stage row is one
        column of ``tile_cols`` adjacent pairs."""
        return _sector_share(self.pairs, self.lx1 * self.ly1, self.tile_cols)

    def report(self) -> dict:
        """The plan's fields and properties, for a JSON row."""
        return dict(dataclasses.asdict(self), passes=self.passes,
                    sector_share=self.sector_share)


def small_plan(lx1: int, ly1: int, C: int, P: int, blocks: int | None = None,
               sms: int = SMS) -> SmallPlan:
    """K7's plan for ``P`` pairs of ``lx1 × ly1`` cells and ``C`` channels
    over ``blocks`` persistent blocks (those the card holds at once,
    :func:`resident_blocks`; None: one a tile).

    A group walks ``tile_rows`` pairs: the most of 8, 4, 2, 1 that still
    gives ``sms`` tiles, so that a short list spreads over as many SMs as
    it can (a run of one pays the pipeline's fill, g-1 of its lx1 + g-1
    steps). ``stage_bytes`` (csrc ``stage_floats``): ``g · span`` rows of
    :func:`stage_stride` floats, each row one lane position's column of the
    block's pairs. ``traffic_bytes``: the tiles
    read once (the group's lanes share each x point through L1), k,
    ``fac``, the cotangent and the gradients once each; no K, static or
    adjoint row goes to device memory or shared memory."""
    g, span = small_lanes(ly1, C)
    tc = THREADS // g
    rows = next((r for r in (TILE_ROWS, 4, 2) if _cdiv(P, r * tc) >= sms), 1)
    tiles = _cdiv(P, rows * tc)
    nb = tiles if blocks is None else max(1, min(tiles, blocks))
    Lx, Ly = lx1 + 1, ly1 + 1
    traffic = {part: small_bytes(P, Lx, Ly, C, part)
               for part in ("forward", "residuals", "backward")}
    return SmallPlan(
        pairs=P, lx1=lx1, ly1=ly1, C=C, g=g, span=span, pad=g * span - ly1,
        spans=tuple(small_spans(ly1, C)),
        tile_rows=rows, tile_cols=tc, pairs_per_tile=rows * tc, tiles=tiles, blocks=nb,
        threads=nb * THREADS, steps=rows * lx1 + g - 1,
        stage_bytes=4 * g * span * stage_stride(g), traffic_bytes=traffic,
        resident=blocks)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _lib():
    lib = load("sigkernel_small")
    lib.sigkernel_small_resident.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.sigkernel_small_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    lib.sigkernel_small_bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    for fn in (lib.sigkernel_small_resident, lib.sigkernel_small_fwd,
               lib.sigkernel_small_bwd):
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
        raise NotImplementedError(
            f"{lx1 + 1}x{ly1 + 1}-node paths with {C} channels are outside K7's "
            f"envelope (ly ≤ {MAX_LY}, C ≤ {MAX_C}); SignatureKernel takes them "
            "by the wavefront (sigkernel.solve_goursat_pde)"
        )
    return lx1, ly1, C, P


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def resident_blocks(span: int, C: int, g: int, part: str, device_index: int) -> int:
    """Blocks of K7's ``part`` ("forward": values only, "residuals",
    "backward") at span template ``span`` and ``g`` lanes a pair (its
    stages' size) resident on the card at once: the occupancy query's
    blocks an SM times the SMs."""
    per_sm = ctypes.c_int(0)
    err = _lib().sigkernel_small_resident(span, C, PARTS[part], g, ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"K7 {part} occupancy query failed: cudaError {err}")
    return per_sm.value * torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_plan(lx1: int, ly1: int, C: int, P: int, part: str, device) -> SmallPlan:
    """:func:`small_plan` for a launch of ``part`` on ``device``: its SMs and
    the kernel's resident blocks there."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    g, span = small_lanes(ly1, C)
    return small_plan(lx1, ly1, C, P, blocks=resident_blocks(span, C, g, part, index),
                      sms=torch.cuda.get_device_properties(index).multi_processor_count)


def small_forward(xt: torch.Tensor, yt: torch.Tensor, residuals: bool):
    """K7's forward on scaled path tiles ``xt [Lx, C, P]``, ``yt [Ly, C, P]``:
    ``(k,)``, or ``(k, fac [lx1, ly1, P])`` with the residual. CPU tensors
    take the twin; CUDA tensors launch the kernel and add one to
    ``small_forward.launches``."""
    if xt.device.type == "cpu":
        return small_forward_plain(xt, yt, residuals)
    lx1, ly1, C, P = _check(xt, yt, "K7")
    k = torch.empty(P, dtype=xt.dtype, device=xt.device)
    fac = (torch.empty(lx1, ly1, P, dtype=xt.dtype, device=xt.device)
           if residuals else None)
    if P == 0:
        return (k, fac) if residuals else (k,)
    plan = launch_plan(lx1, ly1, C, P, "residuals" if residuals else "forward", xt.device)
    err = _lib().sigkernel_small_fwd(
        xt.data_ptr(), yt.data_ptr(), k.data_ptr(), fac.data_ptr() if residuals else None,
        P, lx1 + 1, ly1 + 1, C, plan.g, plan.span, plan.tile_rows, plan.tiles, plan.blocks,
        _stream(xt))
    if err != 0:
        raise RuntimeError(f"K7 forward launch failed: cudaError {err}")
    small_forward.launches += 1
    return (k, fac) if residuals else (k,)


def small_backward(xt: torch.Tensor, yt: torch.Tensor, fac: torch.Tensor,
                   gout: torch.Tensor):
    """K7's backward: ``(dxt, dyt)``, the gradients of ``Σ gout·k`` with
    respect to the scaled tiles, from the forward's ``fac``. CPU tensors
    take the twin; CUDA tensors launch the kernel and add one to
    ``small_backward.launches``."""
    if xt.device.type == "cpu":
        return small_backward_plain(xt, yt, fac, gout)
    lx1, ly1, C, P = _check(xt, yt, "K7 backward")
    if gout.shape != (P,) or gout.dtype != torch.float32 or not gout.is_contiguous():
        raise ValueError("the cotangent must be a contiguous fp32 [P] tensor")
    if (fac.shape != (lx1, ly1, P) or fac.dtype != torch.float32
            or not fac.is_contiguous() or fac.device != xt.device):
        raise ValueError(f"fac must be K7's forward residual, fp32 {(lx1, ly1, P)}")
    dxt = torch.empty_like(xt)
    dyt = torch.empty_like(yt)
    if P == 0:
        return dxt, dyt
    plan = launch_plan(lx1, ly1, C, P, "backward", xt.device)
    err = _lib().sigkernel_small_bwd(
        xt.data_ptr(), yt.data_ptr(), fac.data_ptr(), gout.data_ptr(), dxt.data_ptr(),
        dyt.data_ptr(), P, lx1 + 1, ly1 + 1, C, plan.g, plan.span, plan.tile_rows,
        plan.tiles, plan.blocks, _stream(xt))
    if err != 0:
        raise RuntimeError(f"K7 backward launch failed: cudaError {err}")
    small_backward.launches += 1
    return dxt, dyt


small_forward.launches = 0
small_backward.launches = 0


class _SmallPairGram(torch.autograd.Function):
    """``k [P]`` of pre-scaled gathered paths ``xg [P, Lx, C]``, ``yg [P, Ly,
    C]``. With ``remat`` the forward runs values only and the backward reruns
    it with the residual (the checkpoint of a streamed chunk: ``fac`` lives
    only during the backward); without, the forward keeps ``fac``."""

    @staticmethod
    def forward(ctx, xg, yg, remat):
        xt = xg.permute(1, 2, 0).contiguous()
        yt = yg.permute(1, 2, 0).contiguous()
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return small_forward(xt, yt, residuals=False)[0]
        if remat:
            ctx.save_for_backward(xt, yt)
            return small_forward(xt, yt, residuals=False)[0]
        k, fac = small_forward(xt, yt, residuals=True)
        ctx.save_for_backward(xt, yt, fac)
        return k

    @staticmethod
    def backward(ctx, gout):
        xt, yt, *fac = ctx.saved_tensors
        if not fac:
            fac = small_forward(xt, yt, residuals=True)[1:]
        dxt, dyt = small_backward(xt, yt, fac[0], gout.contiguous())
        return dxt.permute(2, 0, 1), dyt.permute(2, 0, 1), None


def pair_gram_small(X: torch.Tensor, Y: torch.Tensor, ix: torch.Tensor,
                    iy: torch.Tensor, h, remat: bool = False) -> torch.Tensor:
    """λ=0 signature-kernel values ``k [P]`` of the pairs ``(X[ix], Y[iy])``,
    differentiable with respect to X, Y and h: the ``rsqrt(h)`` pre-scale is
    a torch op outside the kernels, as in ``pallas_pair_gram_small``.
    ``remat`` trades a second forward for not keeping ``fac`` between the
    forward and the backward."""
    scale = torch.rsqrt(torch.as_tensor(h, dtype=X.dtype, device=X.device))
    return _SmallPairGram.apply((X * scale)[ix], (Y * scale)[iy], remat)
