"""K2's lane schedule (``csrc/sigkernel_block3.cu``) modelled on the CPU.

The model runs what each lane of a group does, step by step: the spans of
:func:`block3_lanes` / :func:`block3_spans`, the forward pipeline (lane t
sweeps band ``k - t`` with the twin's fused ``_fma`` and hands its right-edge
values and corner to lane t+1), the checkpoint slots indexed by pipeline step
(each read back by the lane that wrote it, checked by a tag), the backward
pipeline right to left (the primal and adjoint columns, the coefficients and
dinc of the span's leftmost coarse column and the running row sums handed to
lane t-1), the right-edge re-anchoring of the last lane from the stored edge
column, and the pull-back of each static node column by the one lane that
owns it. A schedule does not change a cell's arithmetic, so K is bit-equal
to the twin's; dX is held against the twin in fp64 at K2's tolerance (scaled
atol 4e-4, ``tests/test_pallas_block3.py``) and against the fp32 twin at
1e-4. The plan (:func:`block3_plan`) is held to the layout the kernel takes.
"""
import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
from sigsvgd_tpu_torch.kernels.sigkernel_fused import _fma, pair_statics

M = 8
ZS = 1.0 / 64.0
I6 = 1.0 / 6.0


def schedule_model(X: torch.Tensor, h: float):
    """``(K, dX)`` by K2's lane schedule, vectorised over the runs of
    :data:`TILE_ROWS` pairs a group walks (pair p is row ``p // R`` of run
    ``p % R``; padding pairs have seed 0)."""
    n, L, C = X.shape
    l1, G = L - 1, M * (L - 1)
    g, _ = kb3.kernel_lanes(L, C)
    widths = kb3.block3_spans(L, g)
    c0s = [t * l1 // g for t in range(g)]
    TR = kb3.TILE_ROWS
    iu, ju = torch.triu_indices(n, n)
    P = iu.numel()
    R = -(-P // TR)
    xt, yt = kb3._pair_tiles(X, h, iu, ju)                       # [L, C, P]
    xt = torch.cat([xt, xt.new_zeros(L, C, R * TR - P)], -1)
    yt = torch.cat([yt, yt.new_zeros(L, C, R * TR - P)], -1)
    seed = torch.cat([torch.where(iu == ju, 1.0, 2.0), torch.zeros(R * TR - P)]).float()
    gs, z, A, B = pair_statics(xt, yt)
    one, zero = torch.ones(R), torch.zeros(R)
    U, steps = TR * l1, TR * l1 + g - 1

    # ---- forward -------------------------------------------------------
    ck, edge = {}, {}
    kval = [None] * TR
    row = [[one] * (M * w) for w in widths]
    hand = [None] * g
    for k in range(steps):
        out = [None] * g
        for t in range(g):
            u = k - t
            if not 0 <= u < U:
                continue
            r, ci = divmod(u, l1)
            sl = slice(r * R, (r + 1) * R)
            if ci == 0:
                row[t] = [one] * (M * widths[t])
            if t == 0:
                left, corner = [one] * M, [one] * M
            else:
                in_left, in_corner = hand[t]
                left, corner = list(in_left), [in_corner] + list(in_left[:M - 1])
            top0 = left[M - 1]
            for kk in range(widths[t]):
                cj = c0s[t] + kk
                a_, b_ = A[ci, cj, sl], B[ci, cj, sl]
                for tt in range(M):
                    up = row[t][kk * M + tt]
                    for s in range(M):
                        kn = _fma(left[s] + up, a_, -(corner[s] * b_))
                        corner[s], left[s], up = up, kn, kn
                    row[t][kk * M + tt] = up
            ck[k, t] = ((r, ci), [top0] + row[t][:-1])
            if t == g - 1:
                edge[k] = ((r, ci), list(left))
                if ci == l1 - 1:
                    kval[r] = left[M - 1]
            out[t] = (list(left), corner[0])
        hand = [None] + out[:-1]

    # ---- backward ------------------------------------------------------
    lamb = [[zero] * (M * w) for w in widths]
    rowg = torch.zeros(TR, L, C, R)   # the row path's gradient, per pair
    colg = torch.zeros(TR, L, C, R)   # the column path's gradient, per pair
    carry = [zero] * C
    state = [None] * g
    for k in range(steps):
        out = [None] * g
        for t in range(g):
            v = k - (g - 1 - t)
            if not 0 <= v < U:
                continue
            u = U - 1 - v
            r, ci = divmod(u, l1)
            sl = slice(r * R, (r + 1) * R)
            slot = steps - 1 - k
            tag, tops = ck[slot, t]
            assert tag == (r, ci), "a lane reads a slot another band wrote"
            if t == g - 1:
                etag, col = edge[slot]
                assert etag == (r, ci)
                if ci > 0:
                    btag, below = edge[slot - 1]
                    assert btag == (r, ci - 1)
                    p0 = below[M - 1]
                else:
                    p0 = one
                Pc, Lm = [p0] + col, [zero] * (M + 1)
                Ar = Br = dinc_r = swu = swd = zero
                sxu, sxd = [zero] * C, [zero] * C
            else:
                Pc, Lm, Ar, Br, dinc_r, swu, swd, sxu, sxd = state[t]
            if t == 0 and ci == l1 - 1:
                carry = [zero] * C
            xu, xd = xt[ci + 1, :, sl], xt[ci, :, sl]
            c0, c1 = c0s[t], c0s[t] + widths[t]
            gu_r, gd_r = gs[ci + 1, c1, sl], gs[ci, c1, sl]

            def pull_back(E, gu, gd, q):
                nonlocal swu, swd
                wu, wd = -gu * E, gd * E
                swu, swd = swu + wu, swd + wd
                for c in range(C):
                    yv = yt[q, c, sl]
                    sxu[c] = sxu[c] + wu * yv
                    sxd[c] = sxd[c] + wd * yv
                    colg[r, q, c] += 2.0 * ((yv - xu[c]) * wu + (yv - xd[c]) * wd)

            sxu, sxd = list(sxu), list(sxd)
            for kk in reversed(range(widths[t])):
                cj = c0 + kk
                tp = tops[kk * M:(kk + 1) * M]
                gu_l, gd_l = gs[ci + 1, cj, sl], gs[ci, cj, sl]
                z_, a_, b_ = z[ci, cj, sl], A[ci, cj, sl], B[ci, cj, sl]
                Bi = 1.0 / b_
                s1 = s2 = zero
                for tt in reversed(range(M)):
                    j = cj * M + tt + 1
                    ar, br = (Ar, Br) if tt == M - 1 else (a_, b_)
                    if ci == l1 - 1:
                        lt = seed[sl] if j == G else zero
                    else:
                        lt = lamb[t][kk * M + tt]
                    Ln = [None] * (M + 1)
                    Ln[M] = Lm[M] * ar + lt
                    for s in range(M - 1, 0, -1):
                        Ln[s] = Lm[s] * ar + Ln[s + 1] * a_ - Lm[s + 1] * br
                    lamb[t][kk * M + tt] = Ln[1] * a_ - Lm[1] * br
                    if j == 1:
                        Pn = [one] * (M + 1)
                    else:
                        Pn = [None] * (M + 1)
                        Pn[M] = tp[tt]
                        for s in range(M - 1, -1, -1):
                            Pn[s] = ((Pn[s + 1] + Pc[s]) * a_ - Pc[s + 1]) * Bi
                        if ci == 0:
                            Pn[0] = one
                    for s in range(M):
                        s1 = s1 + Ln[s + 1] * (Pn[s + 1] + Pc[s])
                        s2 = s2 + Ln[s + 1] * Pn[s]
                    Pc, Lm = Pn, Ln
                dinc = ((0.5 + z_ * I6) * s1 + (z_ * I6) * s2) * ZS
                pull_back(dinc - dinc_r, gu_r, gd_r, cj + 1)
                dinc_r, gu_r, gd_r, Ar, Br = dinc, gu_l, gd_l, a_, b_
            if t == 0:
                pull_back(-dinc_r, gu_r, gd_r, 0)
                for c in range(C):
                    rowg[r, ci + 1, c] += carry[c] + 2.0 * (xu[c] * swu - sxu[c])
                carry = [2.0 * (xd[c] * swd - sxd[c]) for c in range(C)]
                if ci == 0:
                    rowg[r, 0] += torch.stack(carry)
            out[t] = (Pc, Lm, Ar, Br, dinc_r, swu, swd, sxu, sxd)
        state = out[1:] + [None]

    kv = torch.stack(kval).reshape(-1)[:P]
    K = torch.empty(n, n)
    K[iu, ju] = kv
    K[ju, iu] = kv
    per_pair = lambda a: a.permute(0, 3, 1, 2).reshape(TR * R, L, C)[:P]  # noqa: E731
    dX = torch.zeros(n, L, C)
    dX.index_add_(0, iu, per_pair(rowg))
    dX.index_add_(0, ju, per_pair(colg))
    return K, 0.5 * kb3._scale(X, h) * dX


@pytest.mark.parametrize("n,L,C,h", [(6, 9, 2, 4.0), (5, 13, 3, 2.0), (4, 40, 2, 4.0),
                                     (3, 7, 6, 6.0)])
def test_lane_schedule_matches_the_twin(rng, n, L, C, h):
    """[6, 9, 2] runs 2 lanes a pair, [5, 13, 3] 4, [4, 40, 2] (the flagship
    width) 8 over spans of 4-5 coarse columns, [3, 7, 6] 2 of 3 (the span
    cap at C > 3). The paths are those of
    ``test_torch_block3.py`` and the JAX package's block3 test, the inputs
    K2's tolerance was set on. The model's backward rounds each operation
    on its own, as the fp32 twin does, and sits as near it as two orders of
    the same sums do (scaled 1e-4)."""
    X = torch.from_numpy((rng.normal(size=(n, L, C)) * 0.3).astype(np.float32))
    K, dX = schedule_model(X, h)
    assert torch.equal(K, kb3.block3_gram_plain(X, h))
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), h)
    _, dXp = kb3.block3_gram_and_grad_plain(X, h)
    scale = dX64.abs().max()
    assert ((dX.double() - dX64).abs().max() / scale).item() <= 4e-4
    assert ((dX - dXp).abs().max() / scale).item() <= 1e-4


@pytest.mark.parametrize("C", range(1, 9))
def test_plan_spans_cover_every_coarse_column_once(C):
    """Every L of K2's envelope at C (L ≤ 64 up to C = 3, L·C ≤ 128 beyond)."""
    cap = kb3.span_cap(C)
    for L in range(2, kb3.MAX_L + 1):
        if not kb3.block3_supported(64, L, C, 1.0):
            assert C > kb3.NARROW_C and L * C > kb3.MAX_LC
            continue
        g, span = kb3.kernel_lanes(L, C)
        widths = kb3.block3_spans(L, g)
        assert g & (g - 1) == 0 and g <= 16 and len(widths) == g
        assert sum(widths) == L - 1 and min(widths) >= 1
        assert max(widths) <= span <= cap and span in kb3.SPAN_TEMPLATES
        assert (span, C) in kb3.lanes_instantiations()
        # the fewest lanes that keep every span within the cap
        assert g == 1 or -(-(L - 1) // (g // 2)) > cap
        plan = kb3.block3_plan(64, L, C, blocks=132 * 3)
        assert plan.tile_cols * g == kb3.THREADS and plan.spans == tuple(widths)
        # a block's shared memory fits Hopper's 227 KB three times over
        assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024


def test_plan_at_the_flagship_shape():
    """[1024, 40, 2]: 8 lanes a pair over spans of 4-5 coarse columns, tiles of
    8 × 16 pairs, 319 pipeline steps; the scratch and traffic formulas of
    ``PERF.md``."""
    plan = kb3.block3_plan(1024, 40, 2, blocks=132 * 3)  # an H100's 132 SMs × 3
    assert (plan.g, plan.span, plan.tile_rows, plan.tile_cols) == (8, 5, 8, 16)
    assert plan.spans == (4, 5, 5, 5, 5, 5, 5, 5)
    assert plan.pairs_per_block == 128 and plan.steps == 8 * 39 + 7
    assert plan.tiles == 4160 and plan.blocks == 132 * 3
    # per block: 4 warps × 319 steps × (32 lanes × 40 tops + 4 groups × 8 edge)
    assert kb3.block3_scratch_floats(40, 2) == 4 * 319 * (32 * 40 + 4 * 8)
    assert plan.scratch_floats == 396 * 4 * 319 * 1312
    pairs = 1024 * 1025 // 2
    checkpoints = 2 * pairs * 39 * (312 + 8) * 4         # written once, read once
    partials = 2 * 4160 * (8 + 16) * 80 * 4
    io = 4 * (1024 * 80 + 1024 ** 2 + 1024 * 80)         # X, K, dX
    assert plan.traffic_bytes == checkpoints + partials + io
    assert plan.traffic_bytes / pairs <= 100_000           # ≤ 100 KB a pair
