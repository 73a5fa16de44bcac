"""λ=0 symmetric signature-kernel Gram + gradient (K1), the values-only Gram
(K3), and their plain twins.

Port of ``sigsvgd_tpu/kernels/pallas_sigkernel_block.py::block_gram_and_grad``
and ``::block_gram``. ``block_gram_and_grad(X, h)`` returns ``(K [n, n],
dX [n, L, C])`` with ``dX = ½·∂Σ_{ab}K_ab/∂X``, the detached-second-argument
repulsion that ``SignatureKernel.gram_and_grad`` hands to the Stein
velocity; ``block_gram(X, h)`` returns ``K`` alone (``gram_sym``'s block
route). The outputs are data, not differentiable further.

On a CPU tensor the wrappers run the twins; on a CUDA tensor they launch the
hand-written kernels in ``csrc/sigkernel_block.cu`` or raise. Kernels and
twins share one arithmetic, written out in the twins below: the
static Gram in expand form on paths pre-scaled by √(2/h), the order-0 row
sweep, the per-cell adjoint factor ``fac``, the λ rows top-down and the
pull-back of the row differences ``D[i][q] = dz[i][q-1] - dz[i][q]``.
K1 spreads each pair over a group of lanes (:func:`kernel_lanes`,
:func:`block_plan`); K3 solves a pair in one thread, in bands of
:data:`VALUES_BAND_ROWS` cell rows swept as a skewed wavefront
(:func:`block_values_plan`). Both take the JAX package's block envelope
(C ≤ 8, L·C ≤ 128; :func:`block_values_supported`), K1 also C ≤ 3 up to
L = 64 (:func:`block_supported`).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._build import load

_I6 = 1.0 / 6.0
_I12 = 1.0 / 12.0

# kernel envelopes (csrc/sigkernel_block.cu): L ≤ 64 and C ≤ 8 with L·C ≤ 128
# for both; K1 also C ≤ NARROW_C at any L ≤ 64
MAX_L = 64
MAX_C = 8
MAX_LC = 128
NARROW_C = 3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_supported(n: int, L: int, C: int, h) -> bool:
    """Shapes K1 takes on the card: a bandwidth, n ≥ 2, 2 ≤ L ≤ 64 and
    either C ≤ 3 or C ≤ 8 with L·C ≤ 128, the JAX package's block envelope
    (one instantiation per span template and channel count,
    :func:`lanes_instantiations`; a pair's cell row spreads over at most 16
    lanes, :func:`kernel_lanes`, and a block's shared memory,
    :func:`block_plan`, fits Hopper's 227 KB three times at every such
    shape)."""
    return (h is not None and n >= 2 and 2 <= L <= MAX_L and 1 <= C <= MAX_C
            and (C <= NARROW_C or L * C <= MAX_LC))


def block_values_supported(n: int, L: int, C: int, h) -> bool:
    """Shapes K3 takes on the card: a bandwidth, n ≥ 2, 2 ≤ L ≤ 64,
    1 ≤ C ≤ 8 and L·C ≤ 128, the JAX package's block envelope without its
    VMEM bound (one instantiation per length bucket and channel count the
    envelope reaches, :func:`values_bucket`)."""
    return (h is not None and n >= 2 and 2 <= L <= MAX_L and 1 <= C <= MAX_C
            and L * C <= MAX_LC)


# the JAX package's block envelope (pallas_sigkernel_block.py), copied: the
# routing asks for it beside K1's own
_SB = 16
_LB = 128


def _pick_r(lx1: int) -> int:
    return min(8, lx1)


def _vmem_bytes(L: int, C: int, R: int) -> int:
    row = L * _SB * _LB * 4
    ly1row = (L - 1) * _SB * _LB * 4
    nck = max(1, _cdiv(L - 1, R) - 1)
    return (2 * row + 2 * ly1row + nck * row + 2 * (R + 1) * row + 4 * row
            + C * row)


def jax_block_supported(n: int, L: int, C: int, h) -> bool:
    """Shapes the JAX package's λ=0 block route takes: C ≤ 8, L·C ≤ 128 and
    its VMEM bound. Outside it the JAX package takes the pair list (K7)."""
    return (
        h is not None
        and 2 <= L
        and 1 <= C <= 8
        and L * C <= 128
        and n >= 2
        and _vmem_bytes(L, C, _pick_r(L - 1)) <= 12 * 2**20
    )


def block_values_flops(n: int, L: int, C: int) -> float:
    """fp32 operations of K3, counted as :func:`block_flops` counts: per
    pair ``L²`` static nodes at ``2C+3`` and ``(L-1)²`` cells at 14 (z, A, B
    10, the update 4)."""
    pairs = n * (n + 1) // 2
    return float(pairs * (L * L * (2 * C + 3) + (L - 1) ** 2 * 14))


def block_values_bytes(n: int, L: int, C: int) -> float:
    """Bytes K3 must move: X read once, K written once."""
    return 4.0 * (n * L * C + n * n)


def block_flops(n: int, L: int, C: int) -> float:
    """fp32 operations the function needs, counting an ``exp`` as one and
    each value once (K1 recomputes static rows and z, A, B; that work is not
    counted): per pair ``L²`` static-Gram nodes at ``2C+3`` each, and
    ``(L-1)²`` cells at 10 (z, A, B) + 10 (forward update and adjoint
    factor) + 2 (λ chain) + 14 + 11·C (adjoint and pull-back)."""
    pairs = n * (n + 1) // 2
    per_pair = L * L * (2 * C + 3) + (L - 1) ** 2 * (36 + 11 * C)
    return float(pairs * per_pair)


def block_bytes(n: int, L: int, C: int) -> float:
    """Bytes K1 must move: X read once, K and dX written once."""
    return 4.0 * (n * L * C + n * n + n * L * C)


# ---------------------------------------------------------------------------
# Plain PyTorch twin.
# ---------------------------------------------------------------------------


def _coefs(gup: torch.Tensor, gdn: torch.Tensor):
    z = ((gup[1:] - gup[:-1]) - gdn[1:]) + gdn[:-1]   # [L-1, P]
    return z, 1.0 + z * (0.5 + z * _I12), 1.0 - z * z * _I12


def _channel_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Σ_c u[:, c]·v[:, c]`` summed in channel order, as the kernels sum
    it: ``[.., C, P] → [.., P]``."""
    s = u[:, 0] * v[:, 0]
    for c in range(1, u.shape[1]):
        s = s + u[:, c] * v[:, c]
    return s


def _forward_plain(X: torch.Tensor, h, keep_fac: bool, pairs=None):
    """The forward half both twins share, vectorised over the upper-triangle
    pairs (a ≤ b; only ``pairs = (iu, ju)`` when given) and sequential over
    the grid: the pre-scaled tiles, the static-row function, the values and,
    with ``keep_fac``, the per-cell adjoint factors; ``gdn`` is static row
    L-1. Channel sums run in channel order, as the kernels take them."""
    n, L, C = X.shape
    scale = torch.sqrt(2.0 / torch.as_tensor(h, dtype=X.dtype, device=X.device))
    Xs = X * scale
    iu, ju = pairs if pairs is not None else torch.triu_indices(n, n, device=X.device)
    x = Xs[iu].permute(1, 2, 0).contiguous()  # [L, C, P]
    y = Xs[ju].permute(1, 2, 0).contiguous()
    ynh = -0.5 * _channel_dot(y, y)            # [L, P]
    xnh = -0.5 * _channel_dot(x, x)

    def g_row(p):
        cross = _channel_dot(x[p][None].expand_as(y), y)  # [L, P]
        return torch.exp(cross + (ynh + xnh[p]))

    # node rows bottom-up; fac[i, j] feeds the adjoint of cell (i, j)
    P = iu.shape[0]
    krow = torch.ones(L, P, dtype=X.dtype, device=X.device)
    fac = (torch.empty(L - 1, L - 1, P, dtype=X.dtype, device=X.device)
           if keep_fac else None)
    gdn = g_row(0)
    for i in range(L - 1):
        gup = g_row(i + 1)
        z, A, B = _coefs(gup, gdn)
        new = torch.ones_like(krow)
        for j in range(L - 1):
            new[j + 1] = (new[j] + krow[j + 1]) * A[j] - krow[j] * B[j]
        if keep_fac:
            fac[i] = (new[:-1] + krow[1:]) * (0.5 + z * _I6) + krow[:-1] * (z * _I6)
        krow, gdn = new, gup
    return dict(scale=scale, iu=iu, ju=ju, x=x, y=y, g_row=g_row,
                kval=krow[L - 1], fac=fac, gdn=gdn)


def _assemble_k(kval, iu, ju, n: int) -> torch.Tensor:
    """Both halves of K from the pairs' values; zero where no pair wrote."""
    K = torch.zeros(n, n, dtype=kval.dtype, device=kval.device)
    K[iu, ju] = kval
    K[ju, iu] = kval
    return K


def block_gram_plain(X: torch.Tensor, h) -> torch.Tensor:
    """The K3 contract in plain PyTorch: the forward half of
    :func:`block_gram_and_grad_plain`."""
    f = _forward_plain(X, h, keep_fac=False)
    return _assemble_k(f["kval"], f["iu"], f["ju"], X.shape[0])


def block_gram_and_grad_plain(X: torch.Tensor, h, pairs=None):
    """The K1 contract in plain PyTorch, vectorised over the upper-triangle
    pairs (a ≤ b) and sequential over the grid, with an explicit adjoint.
    With ``pairs = (iu, ju)``, a subset of those pairs (:func:`tile_pairs`
    of a tile subset), K holds only theirs (zero elsewhere) and dX only
    their terms: the sums over a partition of the pairs give the whole
    result."""
    n, L, C = X.shape
    f = _forward_plain(X, h, keep_fac=True, pairs=pairs)
    iu, ju, x, y, g_row, fac = f["iu"], f["ju"], f["x"], f["y"], f["g_row"], f["fac"]
    P = iu.shape[0]
    seed = torch.where(iu == ju, 1.0, 2.0).to(X.dtype)

    # adjoint: λ rows top-down
    lam = torch.zeros(L, P, dtype=X.dtype, device=X.device)
    lam[L - 1] = 1.0
    gup = f["gdn"]
    carry = torch.zeros(C, P, dtype=X.dtype, device=X.device)
    dxr = torch.empty(L, C, P, dtype=X.dtype, device=X.device)
    dyc = torch.zeros(L, C, P, dtype=X.dtype, device=X.device)
    for i in range(L - 2, -1, -1):
        gdn = g_row(i)
        z, A, B = _coefs(gup, gdn)
        for j in range(L - 2, -1, -1):
            lam[j] = lam[j] + lam[j + 1] * A[j]
        t = lam[1:]                            # complete λ[i+1][j+1]
        dz = t * fac[i] * seed
        new = torch.zeros_like(lam)
        new[1:] = t * A
        new[:-1] = new[:-1] - t * B
        D = torch.zeros_like(lam)
        D[1:] = dz
        D[:-1] = D[:-1] - dz
        wh = D * gup
        wl = -D * gdn
        xh, xl = x[i + 1], x[i]                # [C, P]
        dxr[i + 1] = carry + (wh[:, None] * y).sum(0) - xh * wh.sum(0)
        carry = (wl[:, None] * y).sum(0) - xl * wl.sum(0)
        dyc += (wh[:, None] * xh + wl[:, None] * xl) - (wh + wl)[:, None] * y
        lam, gup = new, gdn
    dxr[0] = carry

    dX = torch.zeros_like(X)
    dX.index_add_(0, iu, dxr.permute(2, 0, 1))
    dX.index_add_(0, ju, dyc.permute(2, 0, 1))
    return _assemble_k(f["kval"], iu, ju, n), 0.5 * f["scale"] * dX


# ---------------------------------------------------------------------------
# K1's plan: lanes, spans, tiles (the tile list and the lane rule are K2's
# too, csrc/sigkernel_block3.cu).
# ---------------------------------------------------------------------------

THREADS = 128       # a block: 4 warps
TILE_ROWS = 8       # row particles a tile: the pairs a lane group walks
BAND_ROWS = 4       # cell rows a band, one pipeline step (a band's factors stay in
                    # registers; 4-8 rows measured within 7%, 4 the fastest)
SPAN_CAP = 5        # columns a lane holds at most
SPAN_CAP_WIDE = 3   # K1's and K2's cap at C > NARROW_C
SPAN_TEMPLATES = (3, 5)


def block_lanes(L: int, cap: int = SPAN_CAP) -> tuple[int, int]:
    """``(g, span)``: the fewest lanes a pair (a power of two) that leave no
    lane more than ``cap`` of the ``L - 1`` cell columns, and the span
    template (3 or 5) that holds the widest span."""
    l1 = L - 1
    g = 1
    while _cdiv(l1, g) > cap:
        g *= 2
    widest = _cdiv(l1, g)
    return g, next(t for t in SPAN_TEMPLATES if widest <= t)


def span_cap(C: int) -> int:
    """Columns a K1 or K2 lane holds at most for ``C`` channels: 5 up to
    C = 3, else 3, so the per-lane arrays that grow with C (K1's column-path
    sums, K2's pull-back sums) fit the register budget the C ≤ 3
    instantiations run at."""
    return SPAN_CAP if C <= NARROW_C else SPAN_CAP_WIDE


def kernel_lanes(L: int, C: int) -> tuple[int, int]:
    """``(g, span)`` of K1 and K2 for ``[n, L, C]`` paths: :func:`block_lanes`
    under :func:`span_cap`."""
    return block_lanes(L, span_cap(C))


def lanes_instantiations() -> list[tuple[int, int]]:
    """``(span template, C)`` of every K1 instantiation (and K2's): both
    templates up to C = 3, template 3 beyond."""
    return [(t, C) for C in range(1, MAX_C + 1) for t in SPAN_TEMPLATES
            if t <= span_cap(C)]


def block_spans(L: int, g: int) -> list[int]:
    """Cell columns of each lane: lane t holds ``[t(L-1)/g, (t+1)(L-1)/g)``."""
    l1 = L - 1
    return [(t + 1) * l1 // g - t * l1 // g for t in range(g)]


def _slot_floats(span: int) -> int:
    """Floats of one lane's scratch slot (csrc ``slot_f4``): the band's
    bottom row over the span's ``span + 1`` nodes and its left column of
    :data:`BAND_ROWS` nodes, in whole float4s."""
    return 4 * _cdiv(span + 1 + BAND_ROWS, 4)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """How K1 lays out one call: ``g`` lanes a pair, each holding ``spans``
    [g] cell columns (at most ``span``, the template); bands of
    ``band_rows`` cell rows, ``bands`` a pair; tiles of ``tile_rows`` ×
    ``tile_cols`` pairs, one a block at a time; ``blocks`` persistent blocks
    walk the ``tiles`` of the work list, each group through ``steps``
    pipeline steps a pass. ``scratch_floats`` is the band checkpoints'
    buffer (all blocks), ``smem_bytes`` a block's shared memory,
    ``traffic_bytes`` the device-memory traffic of the call."""
    g: int
    span: int
    spans: tuple
    band_rows: int
    bands: int
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


def _bands(L: int) -> int:
    return _cdiv(L - 1, BAND_ROWS)


def _pipeline_steps(L: int, g: int) -> int:
    """Steps of a group's pipeline over a tile column's 8 pairs: 8 pairs ×
    their bands, the last lane starting g - 1 steps after the first."""
    return TILE_ROWS * _bands(L) + g - 1


def block_scratch_floats(L: int, C: int) -> int:
    """Device scratch per persistent block, in floats: for each of its 4
    warps and each pipeline step, the 32 lanes' slots."""
    g, span = kernel_lanes(L, C)
    return THREADS // 32 * _pipeline_steps(L, g) * 32 * _slot_floats(span)


def block_plan(n: int, L: int, C: int, blocks: int) -> BlockPlan:
    """K1's plan for ``X [n, L, C]`` over ``blocks`` persistent blocks, the
    count the card reports (:func:`block_grid`).

    ``smem_bytes`` (csrc ``lanes_smem_floats``): each lane's copy of its
    next slot, its span of the column path with -½|y'|² [(span+1)·(C+1)]
    and its column-path sums (the same size), the tile's scaled row paths
    with -½|x'|², each warp's row-path sums [8][4][L·C] and each lane's two
    hand-off slots [2][8 rows][3].
    ``traffic_bytes``: each lane of each pair a ≤ b writes its slot once a
    band and reads it back once; X is read once (it stays in L2), K and dX
    written once, the per-tile partials written and read once. No per-cell
    value goes to device or local memory."""
    g, span = kernel_lanes(L, C)
    tc = THREADS // g
    tiles = _tile_list_len(n, tc)
    smem = 4 * ((_slot_floats(span) + 2 * (span + 1) * (C + 1)) * THREADS
                + L * (C + 1) * TILE_ROWS + TILE_ROWS * 4 * L * C
                + 2 * BAND_ROWS * 3 * THREADS)
    pairs = n * (n + 1) // 2
    checkpoints = 2 * pairs * _bands(L) * g * _slot_floats(span)
    partials = 2 * tiles * (TILE_ROWS + tc) * L * C
    return BlockPlan(
        g=g, span=span, spans=tuple(block_spans(L, g)), band_rows=BAND_ROWS,
        bands=_bands(L), tile_rows=TILE_ROWS, tile_cols=tc,
        pairs_per_block=TILE_ROWS * tc, steps=_pipeline_steps(L, g), tiles=tiles,
        blocks=blocks, scratch_floats=blocks * block_scratch_floats(L, C), smem_bytes=smem,
        traffic_bytes=4.0 * (checkpoints + partials + n * L * C + n * n + n * L * C))


_tiles_cache: dict = {}


def _tile_keep(n: int, tc: int):
    nI, nJ = _cdiv(n, TILE_ROWS), _cdiv(n, tc)
    I = torch.arange(nI).repeat_interleave(nJ)
    J = torch.arange(nJ).repeat(nI)
    keep = I * TILE_ROWS <= J * tc + tc - 1
    return I[keep], J[keep]


def _tile_list_len(n: int, tc: int) -> int:
    return int(_tile_keep(n, tc)[0].numel())


def _tile_list(n: int, tc: int, device) -> torch.Tensor:
    """``[T, 2]`` int32 (row tile, column tile) pairs holding a pair a ≤ b,
    for tiles of 8 rows × ``tc`` columns."""
    key = (n, tc, str(device))
    if key not in _tiles_cache:
        _tiles_cache[key] = torch.stack(_tile_keep(n, tc), 1).to(
            device=device, dtype=torch.int32).contiguous()
    return _tiles_cache[key]


def tile_shard(tiles: torch.Tensor, ndev: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s tiles of ``ndev``: every ``ndev``-th tile of the list
    from position ``rank`` on, the JAX package's round-robin
    (``block_tile_shard``) without its zero-weight padding: ranks may hold
    different tile counts."""
    return tiles[rank::ndev].contiguous()


def tile_pairs(tiles: torch.Tensor, n: int, tc: int):
    """``(iu, ju)``: the pairs a ≤ b < n that the tiles of 8 rows × ``tc``
    columns hold, tile after tile, row-major within a tile."""
    t = tiles.to(device="cpu", dtype=torch.int64)
    r = torch.arange(TILE_ROWS)
    c = torch.arange(tc)
    a = (t[:, 0, None, None] * TILE_ROWS + r[None, :, None]).expand(-1, -1, tc)
    b = (t[:, 1, None, None] * tc + c[None, None, :]).expand(-1, TILE_ROWS, -1)
    keep = (a <= b) & (b < n)
    return a[keep].to(tiles.device), b[keep].to(tiles.device)


def tile_mask(tiles: torch.Tensor, n: int, tc: int) -> torch.Tensor:
    """``[ceil(n/8), ceil(n/tc)]`` uint8, 1 for each tile of the list: the
    subset K1's and K2's reductions read (``present`` in their sources)."""
    mask = torch.zeros(_cdiv(n, TILE_ROWS), _cdiv(n, tc), dtype=torch.uint8,
                       device=tiles.device)
    mask[tiles[:, 0].long(), tiles[:, 1].long()] = 1
    return mask


# ---------------------------------------------------------------------------
# K3's plan: one thread a pair, bands of cell rows as a skewed wavefront.
# ---------------------------------------------------------------------------

VALUES_TILE_COLS = 16  # column particles a K3 tile (8 row particles, 128 pairs)
VALUES_BUCKETS = (16, 40, 64)
# cell rows a K3 band by length bucket (csrc band_rows): the wavefront's
# independent chains; 2 the fastest of 1-8 at 16 and 40 nodes
# (tools/k3_probe.py), 4 at 64, where 2 spill
VALUES_BAND_ROWS = {16: 2, 40: 2, 64: 4}


def values_bucket(L: int) -> int:
    """The compile-time length K3 unrolls a row to (16, 40 or 64 nodes);
    nodes past ``L - 1`` repeat node ``L - 1``."""
    return next(b for b in VALUES_BUCKETS if L <= b)


def values_instantiations() -> list[tuple[int, int]]:
    """``(bucket, C)`` of every K3 instantiation: the channel counts each
    length bucket's shortest path reaches inside ``L·C ≤ 128``."""
    out, lo = [], 2
    for b in VALUES_BUCKETS:
        out += [(b, C) for C in range(1, min(MAX_C, MAX_LC // lo) + 1)]
        lo = b + 1
    return out


@dataclasses.dataclass(frozen=True)
class ValuesPlan:
    """How K3 lays out one call: one block of 128 threads a tile of
    ``tile_rows`` × ``tile_cols`` pairs, ``tiles`` of them (those holding a
    pair a ≤ b); each thread sweeps its pair's ``bands`` bands of
    ``band_rows`` cell rows over ``bucket`` columns (the last band's
    ``padded_rows`` rows past the top run and are not kept);
    ``blocks_per_sm`` resident blocks under the launch bounds;
    ``smem_bytes`` a block's staged paths and its threads' bottom static
    rows; ``statics`` and ``cells`` a pair the kernel computes, padding
    included."""
    bucket: int
    band_rows: int
    bands: int
    padded_rows: int
    tile_rows: int
    tile_cols: int
    tiles: int
    blocks_per_sm: int
    smem_bytes: int
    statics: int
    cells: int


def block_values_plan(n: int, L: int, C: int) -> ValuesPlan:
    """K3's plan for ``X [n, L, C]`` (csrc ``block_values_kernel``)."""
    lmax = values_bucket(L)
    R = VALUES_BAND_ROWS[lmax]
    bands = _cdiv(L - 1, R)
    return ValuesPlan(
        bucket=lmax, band_rows=R, bands=bands, padded_rows=bands * R - (L - 1),
        tile_rows=TILE_ROWS, tile_cols=VALUES_TILE_COLS,
        tiles=_tile_list_len(n, VALUES_TILE_COLS), blocks_per_sm=4 if lmax <= 16 else 3,
        smem_bytes=4 * ((C + 1) * (L * TILE_ROWS + lmax * VALUES_TILE_COLS)
                        + lmax * THREADS),
        statics=lmax * (1 + bands * R), cells=(lmax - 1) * bands * R)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _lib():
    lib = load("sigkernel_block")
    lib.sigkernel_block_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sigkernel_block_gram_grad.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.sigkernel_block_gram.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for fn in (lib.sigkernel_block_grid, lib.sigkernel_block_gram_grad,
               lib.sigkernel_block_gram):
        fn.restype = ctypes.c_int
    return lib


def _check(X: torch.Tensor, h, what: str, supported, envelope: str):
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 3 or not X.is_contiguous():
        raise ValueError(f"{what} takes a contiguous fp32 [n, L, C] tensor")
    n, L, C = X.shape
    if not supported(n, L, C, h):
        raise NotImplementedError(
            f"shape {(n, L, C)} is outside {what}'s envelope ({envelope}); "
            "SignatureKernel sends such λ=0 shapes to the pair-list kernel K7 "
            "(beyond C = 8 or ly1 = 63, to the wavefront)"
        )
    return n, L, C, torch.as_tensor(h, dtype=torch.float32, device=X.device).reshape(1)


def block_grid(n: int, L: int, C: int, device) -> tuple[torch.Tensor, int]:
    """The tile list of a K1 launch on ``device`` and its number of
    persistent blocks (those resident on the card, at most one per tile)."""
    g, span = kernel_lanes(L, C)
    tiles = _tile_list(n, THREADS // g, device)
    blocks = ctypes.c_int(0)
    rc = _lib().sigkernel_block_grid(L, C, g, span, tiles.shape[0], ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K1 occupancy query failed: cudaError {rc}")
    return tiles, blocks.value


def block_gram_and_grad(X: torch.Tensor, h, shard=None):
    """``(K, dX)`` for paths ``X [n, L, C]`` and RBF bandwidth ``h`` (float or
    0-d tensor). CPU tensors take the plain twin; CUDA tensors launch K1 and
    add one to ``block_gram_and_grad.launches``. ``shard = (ndev, rank)``
    takes rank's tiles of :func:`tile_shard` only: K holds their pairs
    (zero elsewhere) and dX their terms, so the sums over the ranks are the
    whole result; K1 walks the subset list and its reduction reads only the
    subset's slots (:func:`tile_mask`)."""
    if X.device.type == "cpu":
        if shard is None:
            return block_gram_and_grad_plain(X, h)
        n, L, C = X.shape
        tc = THREADS // kernel_lanes(L, C)[0]
        tiles = tile_shard(_tile_list(n, tc, X.device), *shard)
        return block_gram_and_grad_plain(X, h, pairs=tile_pairs(tiles, n, tc))
    n, L, C, h_t = _check(X, h, "K1", block_supported,
                          f"L ≤ {MAX_L}, C ≤ {NARROW_C} or C ≤ {MAX_C} with L·C ≤ {MAX_LC}")
    g, span = kernel_lanes(L, C)
    tc = THREADS // g
    tiles, blocks = block_grid(n, L, C, X.device)
    present = None
    if shard is not None:
        tiles = tile_shard(tiles, *shard)
        blocks = min(blocks, tiles.shape[0])
        present = tile_mask(tiles, n, tc)
    if tiles.shape[0] == 0:
        return torch.zeros(n, n, dtype=X.dtype, device=X.device), torch.zeros_like(X)
    K = (torch.empty if present is None else torch.zeros)(
        n, n, dtype=X.dtype, device=X.device)
    dX = torch.empty_like(X)
    rowpart = torch.empty(_cdiv(n, tc), n, L * C, dtype=X.dtype, device=X.device)
    colpart = torch.empty(_cdiv(n, TILE_ROWS), n, L * C, dtype=X.dtype, device=X.device)
    scratch = torch.empty(blocks * block_scratch_floats(L, C), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _lib().sigkernel_block_gram_grad(
        X.data_ptr(), h_t.data_ptr(), tiles.data_ptr(), K.data_ptr(), dX.data_ptr(),
        rowpart.data_ptr(), colpart.data_ptr(), scratch.data_ptr(),
        None if present is None else present.data_ptr(), tiles.shape[0],
        blocks, n, L, C, g, span, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    block_gram_and_grad.launches += 1
    return K, dX


def block_gram(X: torch.Tensor, h) -> torch.Tensor:
    """``K [n, n]`` alone, by K1's forward arithmetic: CPU tensors take the
    plain twin; CUDA tensors launch K3 (one block a tile of
    :func:`block_values_plan`) and add one to ``block_gram.launches``."""
    if X.device.type == "cpu":
        return block_gram_plain(X, h)
    n, L, C, h_t = _check(X, h, "K3", block_values_supported,
                          f"L ≤ {MAX_L}, C ≤ {MAX_C}, L·C ≤ {MAX_LC}")
    tiles = _tile_list(n, VALUES_TILE_COLS, X.device)
    K = torch.empty(n, n, dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _lib().sigkernel_block_gram(X.data_ptr(), h_t.data_ptr(), tiles.data_ptr(),
                                     tiles.shape[0], K.data_ptr(), n, L, C, stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    block_gram.launches += 1
    return K


block_gram_and_grad.launches = 0
block_gram.launches = 0


def block_tiles_ks_partial(X: torch.Tensor, h, s: torch.Tensor, ndev: int, rank: int):
    """Rank ``rank``'s partial ``(K@s [n, d], dX [n, L, C])`` over its tiles
    of ``ndev`` (K1 on the card, one launch; the twin on the CPU): the sums
    over the ranks are ``(K@s, dX)`` of :func:`block_gram_and_grad`. Port of
    the JAX package's ``block_tiles_ks_partial`` on this kernel's own tile
    list (its dX already halved). K holds the subset's pairs in both halves
    and zero elsewhere, so ``K@s`` counts a pair a < b once in row a and once
    in row b, and a diagonal pair once."""
    K, dX = block_gram_and_grad(X, h, shard=(ndev, rank))
    return K @ s, dX
