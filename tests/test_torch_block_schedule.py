"""K1's lane schedule (``csrc/sigkernel_block.cu``) modelled on the CPU.

The model runs what each lane of a group does, step by step: the spans of
:func:`block_lanes` / :func:`block_spans`; the forward pipeline (lane t
sweeps band ``k - t`` of its group's 8-pair run over its span and hands its
right column to lane t+1), which writes each band's bottom row over the span
and its left column into the slot of its pipeline step; the adjoint
pipeline right to left (lane t takes unit ``k - (g-1-t)``, bands top down),
which reads back the slot its own forward step wrote (checked by a tag),
rebuilds the band's K rows from it in the forward's rounding, keeps each
cell's ``fac`` of the band and runs the λ rows top down through it, taking
from lane t+1's hand-off slot (checked by a tag), per row, the λ terms and
dz of the cell right of its span; the pull-back of each static node by the
one lane that owns its column (inside and at the right edge of its span,
lane 0 also column 0), once its row is finished (node weights W = dg·g),
the row-path sums taken over the lanes in the order the schedule reaches
them and the column-path sums per band. A schedule does not change a
cell's arithmetic, so K (and every rebuilt ``fac``) is the twin's bit for
bit; dX is held against the fp32 twin and the twin in fp64 at K1's
tolerance (scaled 5e-5, ``tests/test_pallas_block.py``). The plan
(:func:`block_plan`) is held to the layout the kernel takes.
"""
import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

I6 = 1.0 / 6.0
I12 = 1.0 / 12.0
TR = kb.TILE_ROWS


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The model runs tens of thousands of ops on tensors of a few floats:
    on one thread, not beside the JAX runtime's threads; the thread count is
    restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coef(gu, gd, kk):
    z = ((gu[kk + 1] - gu[kk]) - gd[kk + 1]) + gd[kk]
    return z, 1.0 + z * (0.5 + z * I12), 1.0 - z * z * I12


def schedule_model(X: torch.Tensor, h: float):
    """``(K, dX, fac)`` by K1's lane schedule, vectorised over the runs of
    :data:`TILE_ROWS` pairs a group walks (pair p is row ``p // R`` of run
    ``p % R``; padding pairs have seed 0). ``fac`` maps (pair row, cell row,
    cell column) to the rebuilt factor of each cell."""
    n, L, C = X.shape
    plan = kb.block_plan(n, L, C, blocks=1)
    g, widths, RB, nb = plan.g, plan.spans, plan.band_rows, plan.bands
    l1 = L - 1
    c0s = [t * l1 // g for t in range(g)]
    f = kb._forward_plain(X, h, keep_fac=False)   # the twin's statics and paths
    iu, ju = f["iu"], f["ju"]
    P = iu.numel()
    R = -(-P // TR)
    pad = R * TR - P
    gs = torch.stack([f["g_row"](p) for p in range(L)])          # [L, L, P]
    gs = torch.cat([gs, gs.new_zeros(L, L, pad)], -1)
    xt = torch.cat([f["x"], f["x"].new_zeros(L, C, pad)], -1)    # [L, C, P]
    yt = torch.cat([f["y"], f["y"].new_zeros(L, C, pad)], -1)
    seed = torch.cat([torch.where(iu == ju, 1.0, 2.0), torch.zeros(pad)]).float()
    one, zero = torch.ones(R), torch.zeros(R)
    U = TR * nb
    steps = U + g - 1
    assert steps == plan.steps

    def stat_row(p, t, sl):
        return [gs[p, c0s[t] + q, sl] for q in range(widths[t] + 1)]

    # ---- forward: lane t sweeps band k - t; slot (k, t) holds the band's
    # bottom row over the span's nodes and its left column ----------------
    slot, kval = {}, [None] * TR
    krow, corner, gdn = [None] * g, [one] * g, [None] * g
    hand = [None] * g
    for k in range(steps):
        out = [None] * g
        for t in range(g):
            u = k - t
            if not 0 <= u < U:
                continue
            r, v = divmod(u, nb)
            sl = slice(r * R, (r + 1) * R)
            w, i0 = widths[t], v * RB
            if v == 0:
                krow[t], corner[t], gdn[t] = [one] * w, one, stat_row(0, t, sl)
            lc = [one] * (RB + 1) if t == 0 else [corner[t]] + hand[t]
            slot[k, t] = ((r, v), [lc[0]] + krow[t], lc[1:])
            rc = [zero] * RB
            for s in range(RB):
                if i0 + s >= l1:
                    break
                gup = stat_row(i0 + s + 1, t, sl)
                prev, kl = lc[s], lc[s + 1]
                for kk in range(w):
                    _, A, B = _coef(gup, gdn[t], kk)
                    old = krow[t][kk]
                    kn = (kl + old) * A - prev * B
                    krow[t][kk], prev, kl = kn, old, kn
                rc[s] = kl
                gdn[t] = gup
            corner[t] = lc[RB]
            if t == g - 1 and v == nb - 1:
                kval[r] = kl
            out[t] = rc
        hand = [None] + out[:-1]      # lane t+1 takes lane t's right column

    # ---- adjoint: lane t takes unit k - (g-1-t) of the reversed run --------
    rowg = torch.zeros(TR, L, C, R)      # the row path's gradient, per pair
    colx = torch.zeros(TR, L, C, R)      # Σ_rows w·x' of each node column
    colw = torch.zeros(TR, L, R)         # Σ_rows w of each node column
    facs = {}
    lam, wlp = [None] * g, [None] * g
    hin = [None] * g
    owner = {}

    def pull_row(W, r, p, t, sl, cx, cw):
        """Node row p's finished weights pulled back over lane t's owned
        columns: its row-path part added to the pair's, the column sums."""
        w, c0 = widths[t], c0s[t]
        xp = xt[p, :, sl]
        sy, sw = [zero] * C, zero
        for q in ([0] if t == 0 else []) + list(range(1, w + 1)):
            owner[r, p, c0 + q] = owner.get((r, p, c0 + q), 0) + 1
            sw = sw + W[q]
            for c in range(C):
                sy[c] = sy[c] + W[q] * yt[c0 + q, c, sl]
                cx[q][c] = cx[q][c] + W[q] * xp[c]
            cw[q] = cw[q] + W[q]
        for c in range(C):
            rowg[r, p, c] += sy[c] - xp[c] * sw

    for k in range(steps):
        out = [None] * g
        for t in range(g):
            vq = k - (g - 1 - t)
            if not 0 <= vq < U:
                continue
            r, v = divmod(U - 1 - vq, nb)
            sl = slice(r * R, (r + 1) * R)
            w, c0, i0 = widths[t], c0s[t], v * RB
            tag, bottom, left = slot[steps - 1 - k, t]
            assert tag == (r, v), "a lane reads a slot another band wrote"
            if v == nb - 1:
                lam[t] = [zero] * w
                if t == g - 1:
                    lam[t][w - 1] = one           # node (L-1, L-1)
                wlp[t] = [zero] * (w + 1)
            if t < g - 1:
                htag, rows = hin[t]
                assert htag == (r, v), "a lane reads another band's hand-off"
            sd = seed[sl]
            # rebuild the band's K rows from the slot, keeping each fac
            krow_b, lc = list(bottom[1:]), [bottom[0]] + list(left)
            fac = {}
            gd = stat_row(i0, t, sl)
            for s in range(RB):
                if i0 + s >= l1:
                    break
                gu = stat_row(i0 + s + 1, t, sl)
                prev, kl = lc[s], lc[s + 1]
                for kk in range(w):
                    z, A, B = _coef(gu, gd, kk)
                    old = krow_b[kk]
                    sm = kl + old
                    kn = sm * A - prev * B
                    fac[s, kk] = sm * (0.5 + z * I6) + prev * (z * I6)
                    facs[r, i0 + s, c0 + kk] = fac[s, kk]
                    krow_b[kk], prev, kl = kn, old, kn
                gd = gu
            # λ rows top down through the band
            hout = [None] * RB
            cx = [[zero] * C for _ in range(w + 1)]
            cw = [zero] * (w + 1)
            for s in reversed(range(RB)):
                i = i0 + s
                if i >= l1:
                    continue
                gd = stat_row(i, t, sl)
                cA, cB = [], []
                for kk in range(w):
                    _, A, B = _coef(gu, gd, kk)
                    cA.append(A)
                    cB.append(B)
                hA, hB, hD = rows[s] if t < g - 1 else (zero, zero, zero)
                L_ = lam[t]
                for kk in reversed(range(w)):    # complete λ row i+1
                    L_[kk] = L_[kk] + (hA if kk == w - 1 else L_[kk + 1] * cA[kk + 1])
                dz = [L_[kk] * fac[s, kk] * sd for kk in range(w)]
                hout[s] = (L_[0] * cA[0], L_[0] * cB[0], dz[0])
                lam[t] = [L_[kk] * cA[kk] - (hB if kk == w - 1 else L_[kk + 1] * cB[kk + 1])
                          for kk in range(w)]
                # dg of the owned node columns: D = dz[q-1] - dz[q], +D on node
                # row i+1 (then finished), -D on node row i
                D = [zero - dz[0]] + [dz[q - 1] - (hD if q == w else dz[q])
                                      for q in range(1, w + 1)]
                W = [D[q] * gu[q] + wlp[t][q] for q in range(w + 1)]
                wlp[t] = [-D[q] * gd[q] for q in range(w + 1)]
                pull_row(W, r, i + 1, t, sl, cx, cw)
                gu = gd
            if v == 0:
                pull_row(wlp[t], r, 0, t, sl, cx, cw)
            for q in range(w + 1):                # flush the band's column sums
                for c in range(C):
                    colx[r, c0 + q, c] += cx[q][c]
                colw[r, c0 + q] += cw[q]
            out[t] = ((r, v), hout)
        hin = out[1:] + [None]        # lane t-1 takes lane t's hand-off

    kv = torch.stack(kval).reshape(-1)[:P]
    K = torch.empty(n, n)
    K[iu, ju] = kv
    K[ju, iu] = kv
    colg = colx - yt.reshape(L, C, TR, R).permute(2, 0, 1, 3) * colw[:, :, None]
    per_pair = lambda a: a.permute(0, 3, 1, 2).reshape(TR * R, L, C)[:P]  # noqa: E731
    dX = torch.zeros(n, L, C)
    dX.index_add_(0, iu, per_pair(rowg))
    dX.index_add_(0, ju, per_pair(colg))
    # every static node pulled back once, by one lane
    assert set(owner.values()) == {1} and len(owner) == TR * L * L
    return K, 0.5 * f["scale"] * dX, facs, (R, P)


@pytest.mark.parametrize("n,L,C,h", [
    (5, 2, 2, 4.0),     # one cell: 1 lane, one band of one row
    (4, 5, 3, 2.0),     # 1 lane of 4 columns, one full band
    (6, 9, 2, 4.0),     # 2 lanes of 4 columns, two full bands
    (5, 13, 3, 2.0),    # 4 lanes of 3 columns, three full bands
    (3, 30, 1, 4.0),    # 8 lanes of 3-4 columns, eight bands (a ragged last)
    (4, 40, 2, 4.0),    # the flagship width: 8 lanes of 4-5 columns, ten bands
    (3, 45, 2, 1.0),    # 16 lanes of 2-3 columns, eleven bands
    (3, 13, 6, 6.0),    # C = 6: 4 lanes of 3 columns (the span cap at C > 3)
])
def test_lane_schedule_matches_the_twin(rng, n, L, C, h):
    """K and every cell's ``fac`` bit for bit; dX within K1's tolerance of the
    fp32 twin and of the twin in fp64. ``n(n+1)/2`` is never a multiple of 8
    here, so every case has padding pairs beside its diagonal pairs."""
    X = torch.from_numpy((rng.normal(size=(n, L, C)) * 0.3).astype(np.float32))
    K, dX, facs, (R, P) = schedule_model(X, h)
    assert P % TR and kb.kernel_lanes(L, C)[0] == {2: 1, 5: 1, 9: 2, 13: 4, 30: 8,
                                                    40: 8, 45: 16}[L]
    Kp, dXp = kb.block_gram_and_grad_plain(X, h)
    assert torch.equal(K, Kp) and torch.equal(K, kb.block_gram_plain(X, h))
    fac = kb._forward_plain(X, h, keep_fac=True)["fac"]           # [L-1, L-1, P]
    for (r, i, j), got in facs.items():
        p = torch.arange(R) + r * R
        keep = p < P
        assert torch.equal(got[keep], fac[i, j, p[keep]])
    _, dX64 = kb.block_gram_and_grad_plain(X.double(), h)
    scale = dXp.abs().max()
    assert ((dX - dXp).abs().max() / scale).item() <= 5e-5
    assert ((dX.double() - dX64).abs().max() / dX64.abs().max()).item() <= 5e-5


@pytest.mark.parametrize("C", range(1, 9))
def test_plan_spans_cover_every_cell_column_once(C):
    """Every L of K1's envelope at C (L ≤ 64 up to C = 3, L·C ≤ 128 beyond):
    the spans, their instantiation, the bands and the shared memory."""
    cap = kb.span_cap(C)
    for L in range(2, kb.MAX_L + 1):
        if not kb.block_supported(64, L, C, 1.0):
            assert C > kb.NARROW_C and L * C > kb.MAX_LC
            continue
        g, span = kb.kernel_lanes(L, C)
        widths = kb.block_spans(L, g)
        assert g & (g - 1) == 0 and g <= 16 and len(widths) == g
        assert sum(widths) == L - 1 and min(widths) >= 1
        assert max(widths) <= span <= cap and span in kb.SPAN_TEMPLATES
        assert (span, C) in kb.lanes_instantiations()
        # the fewest lanes that keep every span within the cap
        assert g == 1 or -(-(L - 1) // (g // 2)) > cap
        plan = kb.block_plan(64, L, C, blocks=132 * 3)
        assert plan.tile_cols * g == kb.THREADS and plan.spans == tuple(widths)
        assert plan.bands * plan.band_rows >= L - 1 > (plan.bands - 1) * plan.band_rows
        # a block's shared memory fits Hopper's 227 KB three times (12 warps)
        assert 3 * (plan.smem_bytes + 1024) <= 227 * 1024


def test_plan_at_the_flagship_shape():
    """[1024, 40, 2]: 8 lanes a pair over spans of 4-5 cell columns, ten
    bands of 4 rows (the last of 3), tiles of 8 × 16 pairs, 87 pipeline
    steps; the scratch and traffic formulas of ``PERF.md``."""
    plan = kb.block_plan(1024, 40, 2, blocks=132 * 3)  # an H100's 132 SMs × 3
    assert (plan.g, plan.span, plan.tile_rows, plan.tile_cols) == (8, 5, 8, 16)
    assert plan.spans == (4, 5, 5, 5, 5, 5, 5, 5)
    assert (plan.band_rows, plan.bands) == (4, 10)
    assert plan.pairs_per_block == 128 and plan.steps == 8 * 10 + 7
    assert plan.tiles == 4160 and plan.blocks == 132 * 3
    # per block: 4 warps × 87 steps × 32 lanes × a 12-float slot (a bottom row
    # of 6 nodes and a left column of 4, in float4s)
    assert kb.block_scratch_floats(40, 2) == 4 * 87 * 32 * 12
    assert plan.scratch_floats == 396 * 4 * 87 * 32 * 12
    pairs = 1024 * 1025 // 2
    checkpoints = 2 * pairs * 10 * 8 * 12 * 4          # written once, read once
    partials = 2 * 4160 * (8 + 16) * 80 * 4
    io = 4 * (1024 * 80 + 1024 ** 2 + 1024 * 80)        # X, K, dX
    assert plan.traffic_bytes == checkpoints + partials + io
    # against 6,084 B of fac a pair written and read in local memory before
    assert plan.traffic_bytes / pairs <= 2 * 6_084
    # three blocks (12 warps) an SM
    assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
    # a block's shared memory: per lane its slot's copy, its span of the
    # column path and its column sums, 6 × 3 floats each, and two hand-off
    # slots of 4 rows × 3; the row paths [40][3][8]; each warp's row sums
    assert plan.smem_bytes == 4 * ((12 + 2 * 6 * 3 + 2 * 4 * 3) * 128 + 40 * 3 * 8
                                   + 8 * 4 * 80)
