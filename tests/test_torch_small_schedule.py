"""K7's forward and backward (``csrc/sigkernel_small.cu``) modelled lane by
lane on the CPU.

The models run what each lane of a group does, step by step, vectorised
over the groups of all tiles (run position r of every tile in band r of
the pairs), with the lanes, span and runs of :func:`small_plan`. Every lane
holds ``span`` columns of the grid padded to ``g·span`` columns by virtual
ones whose static nodes repeat the edge node's, so z = 0 there:

* the forward pads on the left. Lane t sweeps row ``k - t`` of its run
  (rows bottom up) over its columns ``[t·span - pad, (t+1)·span - pad)``,
  with its span's K row and static row carried from row to row (row i+1
  becomes the next row's lower row); lane t-1 hands it, by
  ``__shfl_up_sync``, the new row's value and static node at the span's
  left edge (lane 0: k = 1 and its first node), and the lane keeps the
  value as the next row's corner. Each cell's ``fac`` goes into the block's
  stage at its lane position and span column, and the block writes the
  real columns out (csrc ``small_fwd_lanes_kernel``): k and every cell's
  ``fac`` are the twin's bit for bit, each written once, which also shows
  that the virtual cells keep k = 1 exactly.
* the backward pads on the right: one pipeline right to left, rows top
  down: lane g-1 takes unit k at step k, lane t unit ``k - (g-1-t)``. Each
  lane owns its span of the row above's partial adjoint λ[i+1] (node
  columns c0+1 .. c0+span), of the static row i+1 (node columns c0 ..
  c0+span) and of the column-path gradient of the nodes it pulls back
  (c0+1 .. c0+span, lane 0 also 0); lane t+1 hands it the increment that
  completes λ[i+1] at the span's right edge, the pending term of λ[i]
  there, that cell's dz, the static node g[i] there and the row-path
  sums. ``fac`` comes through the block's stage (virtual columns read 0).
  The fp32 arithmetic is the kernel's, each rounding as its intrinsics pin
  it (a fused multiply-add by ``_fma``). dx and dy are bit-equal whatever
  the lanes and padding (a schedule does not change a node's arithmetic or
  a sum's order, and virtual columns add exact zeros) and within K7's
  tolerance of the fp32 and fp64 twins.

The statics come from the twin's ``_g_row`` (the kernel forms the same
expression with ``expf``). Tags prove that each lane reads only what its
neighbour handed it, and each stage entry the unit that wrote it; every
output element has one writer. No JAX: the twins are held against the JAX
package in ``test_torch_small.py``.
"""
import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_small as ks
from sigsvgd_tpu_torch.kernels.sigkernel_fused import _fma

I6, I12 = 1.0 / 6.0, 1.0 / 12.0
K7_TOL = (3e-5, 5e-5)   # chip_smoke.K7_TOL: k and fac atol, gradients scaled atol


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The models run tens of thousands of ops on tensors of a few hundred
    floats: on one thread, not beside the JAX runtime's threads; the thread
    count is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Writes:
    """An output tensor whose every element may be written once."""

    def __init__(self, shape):
        self.value = torch.full(shape, float("nan"))
        self.count = torch.zeros(shape, dtype=torch.int64)

    def put(self, index, value, ok):
        index = tuple(i[ok] if torch.is_tensor(i) and i.dim() else i for i in index)
        self.count[index] += 1
        self.value[index] = value[ok]

    def done(self):
        assert (self.count == 1).all(), "an output element written twice or never"
        return self.value


def _layout(xt, yt, sms, g):
    """The plan's lanes, span, padding and runs (with ``g``, the same rule
    at g lanes a pair, each holding ⌈ly1/g⌉ columns) and every run
    position's pairs, over the groups of all tiles (group ``tile·128/g +
    gi`` takes pair ``r·tiles·128/g + tile·128/g + gi`` at run position
    r)."""
    Lx, C, P = xt.shape
    lx1, ly1 = Lx - 1, yt.shape[0] - 1
    plan = ks.small_plan(lx1, ly1, C, P, sms=sms)
    g, span = (plan.g, plan.span) if g is None else (g, -(-ly1 // g))
    tc = ks.THREADS // g
    R = next((r for r in (ks.TILE_ROWS, 4, 2) if -(-P // (r * tc)) >= sms), 1)
    grp = torch.arange(-(-P // (R * tc)) * tc)
    # band-major: run position r of every tile lies in band r of the pairs
    pidx = [r * grp.numel() + grp for r in range(R)]
    return g, span, g * span - ly1, pidx, R * lx1


def statics(xt, yt):
    """``[Lx, Ly, P]``: row i is the twin's ``_g_row`` of x point i."""
    yn = ks._sq_norms(yt)
    return torch.stack([ks._g_row(xt[i], yt, yn) for i in range(xt.shape[0])])


def coef(gu1, gu0, gl1, gl0):
    z = ((gu1 - gu0) - gl1) + gl0
    return z, 1.0 + z * (0.5 + z * I12), 1.0 - (z * z) * I12


def forward_model(xt, yt, residuals=True, sms=ks.SMS, g=None):
    """``(k, fac)`` by K7's forward lane schedule (``fac`` None values only)."""
    Lx, C, P = xt.shape
    lx1, ly1 = Lx - 1, yt.shape[0] - 1
    g, W, pad, pidx, U = _layout(xt, yt, sms, g)
    gst = statics(xt, yt)
    node = lambda q: min(max(q, 0), ly1)   # noqa: E731  (a virtual node is node 0)
    kval, fac = Writes((P,)), Writes((lx1, ly1, P)) if residuals else None
    krow, grow, hand = [None] * g, [None] * g, [None] * g
    for k in range(U + g - 1):
        out, stage = [None] * g, {}
        for t in range(g):
            u = k - t
            if not 0 <= u < U:
                continue
            r, i = divmod(u, lx1)
            p = pidx[r]
            ok = p < P
            pc = torch.where(ok, p, 0)
            c0 = t * W - pad
            one = torch.ones(p.shape)
            if i == 0:   # a pair's start: row 0 of K is one; the static row of x point 0
                krow[t] = [one] * (W + 1)   # [0]: k[i][c0], the corner, then k[i][c0+1..]
                grow[t] = [gst[0, node(c0 + q), pc] for q in range(W + 1)]
            gn = [gst[i + 1, node(c0 + 1 + q), pc] for q in range(W)]
            prev = krow[t][0]
            if t == 0:
                kl, gu0 = one, gn[0] if pad > 0 else gst[i + 1, 0, pc]
            else:
                tag, kl, gu0 = hand[t]
                assert tag == (r, i), "lane t took another unit's left edge"
            kl_in = kl
            gl0 = grow[t][0]
            for q in range(W):
                gu1, gl1 = gn[q], grow[t][q + 1]
                z, A, B = coef(gu1, gu0, gl1, gl0)
                old = krow[t][q + 1]
                s = kl + old
                kn = s * A - prev * B
                if residuals:
                    stage[t * W + q] = ((r, i), s * (0.5 + z * I6) + prev * (z * I6))
                krow[t][q + 1] = kn
                grow[t][q] = gu0                   # row i+1, the next row's lower row
                prev, kl, gu0, gl0 = old, kn, gu1, gl1
            grow[t][W] = gu0
            if t > 0:
                krow[t][0] = kl_in
            if t == g - 1 and i == lx1 - 1:
                kval.put((p,), kl, ok)
            out[t] = ((r, i), kl, gu0)
        hand = [None] + out[:-1]
        if residuals:   # the block writes its stage out, a column of its pairs a row
            for j in range(ly1):
                t = (j + pad) // W
                u = k - t
                if not 0 <= u < U:
                    continue
                r, i = divmod(u, lx1)
                tag, v = stage[j + pad]
                assert tag == (r, i), "a stage row read before its lane wrote it"
                fac.put((i, j, pidx[r]), v, pidx[r] < P)
    return kval.done(), fac.done() if residuals else None


def _pull(D, gh, gl, y, dyq, S, xh, xl):
    """csrc ``pull_back``: D through node q's row i+1 (``gh``, x point
    ``xh``) and row i (``gl``, ``xl``) statics; the row-path sums in ``S``,
    the column path's gradient into ``dyq``."""
    wh = D * gh
    wl = -(D * gl)
    S["swh"] = S["swh"] + wh
    S["swl"] = S["swl"] + wl
    for c in range(len(y)):
        S["sxh"][c] = _fma(wh, y[c], S["sxh"][c])
        S["sxl"][c] = _fma(wl, y[c], S["sxl"][c])
        s = _fma(wh, y[c] - xh[c], wl * (y[c] - xl[c]))
        dyq[c] = dyq[c] - 2.0 * s


def backward_model(xt, yt, fac, gout, sms=ks.SMS, g=None):
    """``(dx, dy)`` by K7's backward lane schedule from the forward's ``fac``."""
    Lx, C, P = xt.shape
    lx1, ly1 = Lx - 1, yt.shape[0] - 1
    g, W, pad, pidx, U = _layout(xt, yt, sms, g)
    gst = statics(xt, yt)
    node = lambda q: min(q, ly1)   # noqa: E731  (a virtual node is node ly1)
    dx, dy = Writes((Lx, C, P)), Writes((ly1 + 1, C, P))
    lam, gs, dyl, xh, yl = ([None] * g for _ in range(5))
    carry, hand = None, [None] * g
    for k in range(U + g - 1):
        stage = {}   # the block's stage for this step, loaded ahead; virtual rows 0
        for j in range(ly1):
            t = j // W
            u = k - (g - 1 - t)
            if 0 <= u < U:
                r = u // lx1
                i = lx1 - 1 - (u - r * lx1)
                stage[j] = ((r, i), fac[i, j, torch.where(pidx[r] < P, pidx[r], 0)])
        out = [None] * g
        for t in range(g):
            u = k - (g - 1 - t)
            if not 0 <= u < U:
                continue
            r = u // lx1
            i = lx1 - 1 - (u - r * lx1)
            p = pidx[r]
            ok = p < P
            pc = torch.where(ok, p, 0)
            c0 = t * W
            zero = torch.zeros(p.shape)
            if i == lx1 - 1:   # a pair's start: the seed, static row lx1, clean sums
                yl[t] = [[yt[node(c0 + q), c, pc] for c in range(C)] for q in range(W + 1)]
                gs[t] = [gst[lx1, node(c0 + q), pc] for q in range(W + 1)]
                lam[t] = [gout[pc] if c0 + q == ly1 else zero for q in range(W + 1)]
                dyl[t] = [[zero] * C for _ in range(W + 1)]
                xh[t] = [xt[lx1, c, pc] for c in range(C)]
                if t == 0:
                    carry = [zero] * C
            xl = [xt[i, c, pc] for c in range(C)]
            gn = [gst[i, node(c0 + q), pc] for q in range(W)]
            if t == g - 1:
                R, pending, dzr = lam[t][W], zero, zero
                gl_r = gn[W - 1] if pad > 0 else gst[i, ly1, pc]
                S = {"swh": zero, "swl": zero, "sxh": [zero] * C, "sxl": [zero] * C}
            else:
                tag, tin, pending, dzr, gl_r, S = hand[t]
                assert tag == (r, i), "lane t took another unit's right edge"
                R = lam[t][W] + tin          # completes λ[i+1] at the span's right edge
                S = {"swh": S["swh"], "swl": S["swl"], "sxh": list(S["sxh"]),
                     "sxl": list(S["sxl"])}
            for q in range(W - 1, -1, -1):   # cell (i, c0+q), right to left
                gl0 = gn[q]
                z, A, B = coef(gs[t][q + 1], gs[t][q], gl_r, gl0)
                tt = R * A
                lam_new = pending + tt       # λ[i][c0+q+1], partial
                pending = -(R * B)
                tag, fv = stage.get(c0 + q, ((r, i), zero))
                assert tag == (r, i), "a lane read another unit's fac"
                dz = R * fv
                _pull(dz - dzr, gs[t][q + 1], gl_r, yl[t][q + 1], dyl[t][q + 1], S, xh[t], xl)
                lam[t][q + 1] = lam_new
                gs[t][q + 1] = gl_r          # row i, the next row's upper row
                if q > 0:
                    R = lam[t][q] + tt       # completes λ[i+1][c0+q]
                dzr, gl_r = dz, gl0
            if t == 0:   # node column 0 and the row-path gradients
                _pull(-dzr, gs[t][0], gl_r, yl[t][0], dyl[t][0], S, xh[t], xl)
                for c in range(C):
                    dx.put((i + 1, c, p), carry[c] + 2.0 * (S["sxh"][c] - xh[t][c] * S["swh"]),
                           ok)
                    carry[c] = 2.0 * (S["sxl"][c] - xl[c] * S["swl"])
                    if i == 0:
                        dx.put((0, c, p), carry[c], ok)
            gs[t][0] = gl_r
            if i == 0:   # the pair's end: the column-path gradients of the lane's nodes
                for q in range(0 if t == 0 else 1, W + 1):
                    if c0 + q <= ly1:
                        for c in range(C):
                            dy.put((c0 + q, c, p), dyl[t][q][c], ok)
            xh[t] = xl
            out[t] = ((r, i), tt, pending, dzr, gl_r, S)
        hand = out[1:] + [None]
    return dx.done(), dy.done()


def _tiles(rng, P, Lx, Ly, C):
    """Scaled tiles of ``P`` random pairs of random-walk paths (steps of
    0.3 at h = 1.7, the JAX K7 test's scale) and a cotangent."""
    X = np.cumsum(rng.normal(size=(16, Lx, C)) * 0.3, 1) / np.sqrt(1.7)
    Y = np.cumsum(rng.normal(size=(16, Ly, C)) * 0.3, 1) / np.sqrt(1.7)
    ix, iy = rng.integers(0, 16, P), rng.integers(0, 16, P)
    xt = torch.from_numpy(X[ix].transpose(1, 2, 0).astype(np.float32)).contiguous()
    yt = torch.from_numpy(Y[iy].transpose(1, 2, 0).astype(np.float32)).contiguous()
    return xt, yt, torch.from_numpy(rng.standard_normal(P).astype(np.float32))


CASES = [
    (300, 40, 40, 2, ks.SMS),   # g = 8, spans 4-5: the streamed Gram's shape
    (200, 64, 64, 8, ks.SMS),   # ly1 = 63, C = 8: 32 lanes of 1-2 columns
    (300, 23, 9, 3, ks.SMS),    # Lx ≠ Ly, g = 2
    (41, 6, 18, 2, 1),          # g = 4, runs of 8 pairs (two live), odd P
    (37, 2, 2, 1, ks.SMS),      # lx1 = ly1 = 1: one cell, one lane
    (33, 2, 41, 4, ks.SMS),     # lx1 = 1, g = 8
    (29, 17, 2, 5, 1),          # ly1 = 1, runs of 8 pairs
]
IDS = ["40x2_g8", "64x8_g32", "23x9x3_g2", "g4_runs", "one_cell", "lx1_1", "ly1_1_runs"]


@pytest.mark.parametrize("P,Lx,Ly,C,sms", CASES, ids=IDS)
def test_forward_schedule_is_the_twin(rng, P, Lx, Ly, C, sms):
    """k and every cell's ``fac`` bit-equal to ``small_forward_plain``, each
    written once; values only, the same k."""
    xt, yt, _ = _tiles(rng, P, Lx, Ly, C)
    k, fac = forward_model(xt, yt, True, sms)
    kp, facp = ks.small_forward_plain(xt, yt, residuals=True)
    assert torch.equal(k, kp) and torch.equal(fac, facp)
    assert torch.equal(forward_model(xt, yt, False, sms)[0], kp)


@pytest.mark.parametrize("P,Lx,Ly,C,sms", CASES, ids=IDS)
def test_backward_schedule_holds_the_twins(rng, P, Lx, Ly, C, sms):
    """dx and dy, scaled by their max, within K7's 5e-5 of the fp32 twin and
    of the fp64 twin (the pull-back splits each node's dg by rows, as the
    kernel does, where the twin sums it first)."""
    xt, yt, gout = _tiles(rng, P, Lx, Ly, C)
    _, facp = ks.small_forward_plain(xt, yt, residuals=True)
    dx, dy = backward_model(xt, yt, facp, gout, sms)
    dxp, dyp = ks.small_backward_plain(xt, yt, facp, gout)
    x64, y64 = xt.double(), yt.double()
    dx64, dy64 = ks.small_backward_plain(x64, y64, ks.small_forward_plain(x64, y64, True)[1],
                                         gout.double())
    for got, want in ((dx, dxp), (dy, dyp), (dx, dx64), (dy, dy64)):
        err = ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()
        assert err <= K7_TOL[1], err


@pytest.mark.parametrize("P,Lx,Ly,C,sms,gs", [
    (300, 40, 40, 2, ks.SMS, (1, 2, 16)),     # pads 0, 1, 9 against 1
    (41, 6, 18, 2, 1, (1, 8)),                # pads 0, 7 against 3
    (50, 9, 64, 8, ks.SMS, (4, 16)),          # pads 1, 1 against 33
], ids=["40x2", "g4_runs", "ly63_c8"])
def test_backward_is_bit_equal_across_lane_counts(rng, P, Lx, Ly, C, sms, gs):
    """A pair's lanes split its columns, not its arithmetic: dx and dy at
    the plan's lanes bit-equal to those at other lane counts (each node's
    chain and each sum in the same order)."""
    xt, yt, gout = _tiles(rng, P, Lx, Ly, C)
    _, facp = ks.small_forward_plain(xt, yt, residuals=True)
    got = backward_model(xt, yt, facp, gout, sms)
    for g in gs:
        other = backward_model(xt, yt, facp, gout, sms, g=g)
        assert all(torch.equal(a, b) for a, b in zip(got, other)), g


def test_plan_at_the_card_shapes():
    """The smoke's lists: 8 lanes a pair over spans of 4-5 columns at ly1 =
    39 (runs of 8, tiles of 128 pairs, 16 and 8 passes over 4 blocks an
    SM), 16 lanes at ly1 = 63, spans of at most 3 from C = 5 on; every
    residual row of the two flagship lists moves in whole sectors (16
    adjacent pairs a stage row); the traffic is the bound's bytes."""
    P = 1 << 20
    plan = ks.small_plan(39, 39, 2, P, blocks=132 * 4)
    assert (plan.g, plan.span, plan.pad, plan.spans) == (8, 5, 1, (4, 5, 5, 5, 5, 5, 5, 5))
    assert (plan.tile_rows, plan.tile_cols, plan.pairs_per_tile) == (8, 16, 128)
    assert (plan.tiles, plan.blocks, plan.threads, plan.passes) == (8192, 528, 528 * 128, 16)
    assert plan.steps == 8 * 39 + 7
    assert plan.stage_bytes == 4 * 8 * 5 * 20
    assert plan.traffic_bytes == {part: ks.small_bytes(P, 40, 40, 2, part)
                                  for part in ("forward", "residuals", "backward")}
    assert plan.sector_share == 1.0
    tri = ks.small_plan(39, 39, 2, 524_800, blocks=132 * 4)
    assert (tri.tiles, tri.passes, tri.sector_share) == (4100, 8, 1.0)
    for (lx1, ly1, C), (g, span, pad) in {
            (63, 63, 3): (16, 5, 17), (40, 40, 4): (8, 5, 0), (19, 19, 8): (8, 3, 5),
            (2, 2, 7): (1, 3, 1), (39, 32, 2): (8, 5, 8), (39, 39, 8): (16, 3, 9),
            (63, 63, 8): (32, 3, 33), (4, 5, 2): (1, 5, 0)}.items():
        plan = ks.small_plan(lx1, ly1, C, 5000)
        assert (plan.g, plan.span, plan.pad) == (g, span, pad), (lx1, ly1, C)


def test_plan_envelope():
    """Every shape the kernels take: the spans cover ly1 once, the padded
    grid the lanes' template spans, at most the channel count's cap a
    lane; at most 32 lanes (a warp);
    a block's three stages within 12 KiB; a short list in runs of one
    pair."""
    for ly1 in range(1, ks.MAX_LY):
        for C in range(1, ks.MAX_C + 1):
            plan = ks.small_plan(7, ly1, C, 1000)
            assert sum(plan.spans) == ly1 and len(plan.spans) == plan.g <= 32
            assert plan.g * plan.span == ly1 + plan.pad and plan.span <= ks.span_cap(C)
            assert -(-ly1 // plan.g) <= plan.span and plan.pad < plan.g * plan.span
            assert plan.g * plan.tile_cols == ks.THREADS and plan.tile_rows == 1
            assert 3 * plan.stage_bytes <= 12288
            assert plan.tiles * plan.pairs_per_tile >= 1000
