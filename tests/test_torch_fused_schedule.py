"""K4's forward, K4's fp32 backward and K6 (``csrc/sigkernel_fused.cu``)
modelled lane by lane on the CPU.

The models run what each lane of a group does, step by step, vectorised
over the groups of all tiles, with the spans and runs of :func:`fused_plan`:

* K4's forward: lane t sweeps band ``k - t`` of its run (bands bottom up)
  over its span with the twin's fused ``_fma``, forms the band's upper
  static row from the static Gram and carries it as the next band's lower
  row, hands its right-edge values and corner to lane t+1, and writes its
  span of each checkpoint band's top row into ``ck [nslots, 8·ly1+1, P]``
  (lane 0 also column 0) and, as the last lane, the band's right edge into
  ``rc [lx1, 8, P]``. k, ck and rc are the twin's bit for bit.
* K4's backward: one pipeline right to left over the units (pair, band),
  bands top down: lane g-1 takes unit k at step k, lane t unit
  ``k - (g-1-t)``. Each lane owns its span of the band's top-row primal kb
  (replaced by the checkpoint row at anchored bands, else the band above's
  rebuild toward -j), of the band above's part of the adjoint of the top
  row and of the band's upper static row (the lower row carried as the next
  band's upper), and hands lane t-1 the adjoint of the band's 8 rows and
  the primal of its 9 at its left edge, the A and B of the cell to its
  right, that cell's dz and the row-path sums; lane g-1 starts every row at
  its fp32 right edge ``rc`` and adds the seed at the top band. The fp32
  arithmetic is the kernel's, each rounding as its intrinsics pin it (a
  fused multiply-add by ``_fma``). Each lane pulls dz back into the node
  columns it owns; lane 0 writes the band's row-path gradient. dx and dy
  are bit-equal whatever the lanes (a schedule does not change a node's
  arithmetic) and within K4's tolerance of the fp32 and fp64 twins.
* K6: one pipeline right to left over the units (couple, band), bands top
  down: lane g-1 takes unit k at step k, lane t unit ``k - (g-1-t)``. Each
  lane owns its span of the band's top-row primal kb, of the adjoint row gb
  and of the band above's z/2, in torch bf16 (one rounding an operation, as
  the twin and the kernel's bf16x2 instructions), replaces its span of kb
  by the bf16 checkpoint at anchored bands, and hands lane t-1 the rows'
  ρ, σ and previous-column outputs, row 0's inputs, the z/2 of the cell to
  the right, the pull-back's per-pair state and the row-path sums; lane g-1
  starts every unit from the fp32 right edges and adds the seed at the top
  band. Each lane pulls dz back through its own cells into the node columns
  it owns; lane 0 writes the band's row-path gradient. Every coarse cell's
  dz is the twin's (``bf16_dz``) bit for bit; dx and dy are within scaled
  1e-5 of the twin's (only the fp32 sums' order differs).

Tags prove that each lane reads only what its neighbour handed it or what
it owns: the hand-offs carry their unit, a lane's rows and static row the
unit that last wrote them, and every residual float, dz and gradient entry
its single writer. No JAX: the twins are held against the JAX package in
``test_torch_fused.py`` and ``test_torch_fused_bf16.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf
from sigsvgd_tpu_torch.kernels.sigkernel_fused import _fma

M = 8
ZS = 1.0 / 64.0
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The models run tens of thousands of ops on tensors of a few dozen
    floats: on one thread, not beside the JAX runtime's threads; the
    thread count is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(plan, units):
    """Per run position r, the unit (pair, K6: couple) of every group of
    every tile, and whether the run position holds any live unit."""
    tc, R = plan.tile_cols, plan.tile_rows
    grp = torch.arange(plan.tiles * tc)
    tile, gi = grp // tc, grp % tc
    idx = [tile * R * tc + r * tc + gi for r in range(R)]
    return idx, [bool((i < units).any()) for i in idx]


class Writes:
    """A residual or output tensor whose every element may be written once."""

    def __init__(self, shape):
        self.value = torch.full(shape, float("nan"))
        self.count = torch.zeros(shape, dtype=torch.int64)

    def put(self, index, value, ok):
        index = tuple(i[ok] if torch.is_tensor(i) and i.dim() else i for i in index)
        self.count[index] += 1
        self.value[index] = value[ok]


def forward_model(xt, yt, sms=kf.SMS):
    """``(k, ck, rc)`` by K4's forward lane schedule on ``xt [Lx, C, P]``,
    ``yt [Ly, C, P]``, with the static Gram taken from ``pair_statics``."""
    Lx, C, P = xt.shape
    lx1, ly1 = Lx - 1, yt.shape[0] - 1
    plan = kf.fused_plan(P, lx1, ly1, C, "forward", sms=sms)
    g, R = plan.g, plan.tile_rows
    G = M * ly1
    bpc = kf._bands_per_ck(lx1)
    c0s = [t * ly1 // g for t in range(g)]
    widths = list(plan.spans)
    gst = kf.pair_statics(xt, yt)[0]
    pidx, live = _groups(plan, P)
    ck = Writes((kf._n_ck_slots(lx1, bpc), G + 1, P))
    rc = Writes((lx1, M, P))
    kval = Writes((P,))
    U = R * lx1
    row, gd, gd_tag, edge = [None] * g, [None] * g, [None] * g, [None] * g
    hand = [None] * g
    for k in range(U + g - 1):
        out = [None] * g
        for t in range(g):
            u = k - t
            if not (0 <= u < U and live[u // lx1]):
                continue
            r, b = divmod(u, lx1)
            p = pidx[r]
            ok = p < P
            pc = torch.where(ok, p, 0)
            c0, w = c0s[t], widths[t]
            if b == 0:  # a pair's start: ones below, the static row of node row 0
                one = torch.ones(p.shape)
                row[t] = [one] * (M * w)
                edge[t] = one
                gd[t] = [gst[0, c0 + q, pc] for q in range(w + 1)]
                gd_tag[t] = (r, 0)
            assert gd_tag[t] == (r, b), "a lane used another band's static row"
            if t == 0:
                left, corner = [torch.ones(p.shape)] * M, [torch.ones(p.shape)] * M
            else:
                tag, in_left, in_corner = hand[t]
                assert tag == (r, b), "lane t took another unit's carries"
                left, corner = list(in_left), [in_corner] + list(in_left[:M - 1])
            keep = (b + 1) % bpc == 0 or b == lx1 - 1
            slot = b // bpc
            if keep and t == 0:
                ck.put((slot, 0, p), torch.ones(p.shape), ok)
            gu0 = gst[b + 1, c0, pc]
            for kk in range(w):
                gu1 = gst[b + 1, c0 + kk + 1, pc]
                z = (((gu1 - gu0) - gd[t][kk + 1]) + gd[t][kk]) * ZS
                A, B = kf._coef(z)
                gd[t][kk] = gu0                    # the next band's lower row
                if kk + 1 == w:
                    gd[t][kk + 1] = gu1
                gu0 = gu1
                for tt in range(M):
                    up = row[t][kk * M + tt]
                    for s in range(M):
                        kn = _fma(left[s] + up, A, -(corner[s] * B))
                        corner[s], left[s], up = up, kn, kn
                    row[t][kk * M + tt] = up
                    if keep:
                        ck.put((slot, 1 + M * (c0 + kk) + tt, p), up, ok)
            gd_tag[t] = (r, b + 1)
            if t == g - 1:
                rc.put((b, 0, p), edge[t], ok)
                for s in range(1, M):
                    rc.put((b, s, p), left[s - 1], ok)
                edge[t] = left[M - 1]
                if b == lx1 - 1:
                    kval.put((p,), left[M - 1], ok)
            out[t] = ((r, b), list(left), corner[0])
        hand = [None] + out[:-1]
    for what in (ck, rc, kval):
        assert (what.count == 1).all(), "a residual float written twice or never"
    return kval.value, ck.value, rc.value


def _state0(shape, C):
    zero = torch.zeros(shape)
    return {"dz": zero, "gu": zero, "gd": zero, "swu": zero, "swd": zero,
            "sxu": [zero] * C, "sxd": [zero] * C}


def _pull(E, S, y, dys, xu, xd, gu=None, gd=None):
    """csrc ``pull_back``: E through the upper (+E) and lower (-E) static
    nodes ``gu``, ``gd`` of one column (default ``S``'s), the row-path sums
    in ``S``, the column path's gradient into ``dys``."""
    wu = -(S["gu"] if gu is None else gu) * E
    wd = (S["gd"] if gd is None else gd) * E
    S["swu"] = S["swu"] + wu
    S["swd"] = S["swd"] + wd
    for c in range(len(y)):
        S["sxu"][c] = _fma(wu, y[c], S["sxu"][c])
        S["sxd"][c] = _fma(wd, y[c], S["sxd"][c])
        dys[c] = dys[c] + 2.0 * ((y[c] - xu[c]) * wu + (y[c] - xd[c]) * wd)


def bf16_model(xt, yt, ck, rc, gout, sms=kf.SMS):
    """``(dz, dx, dy)`` by K6's lane schedule from the forward's residuals."""
    Lx, C, P = xt.shape
    Ly = yt.shape[0]
    lx1, ly1 = Lx - 1, Ly - 1
    plan = kf.fused_plan(P, lx1, ly1, C, "bf16", sms=sms)
    g, R = plan.g, plan.tile_rows
    G = M * ly1
    bpc = kf._bands_per_ck(lx1)
    c0s = [t * ly1 // g for t in range(g)]
    widths = list(plan.spans)
    gst = kf.pair_statics(xt, yt)[0]
    Q = (P + 1) // 2
    qidx, live = _groups(plan, Q)
    shape = (2, qidx[0].numel())       # (the couple's two pairs, groups)
    zero16 = torch.zeros(shape, dtype=BF)
    dz = Writes((lx1, ly1, P))
    dx, dy = Writes((Lx, C, P)), Writes((Ly, C, P))
    U = R * lx1
    # what each lane owns, with the unit that last wrote it
    kb = [[zero16] * (M * w) for w in widths]
    gb = [[zero16] * (M * w) for w in widths]
    zhu = [[zero16] * w for w in widths]
    own = [{"kb": None, "gb": ("reset", 0), "zhu": ("reset", 0), "kbG": None}
           for _ in range(g)]
    kbG = [None] * g
    dys = [[[torch.zeros(shape)] * C for _ in range(w + 1)] for w in widths]
    carry = [[torch.zeros(shape)] * C for _ in range(g)]
    hand = [None] * g
    for k in range(U + g - 1):
        out = [None] * g
        for t in range(g):
            u = k - (g - 1 - t)
            if not (0 <= u < U and live[u // lx1]):
                continue
            r = u // lx1
            b = lx1 - 1 - (u - r * lx1)
            q = qidx[r]
            okq = q < Q
            p0 = torch.where(okq, 2 * q, 0)
            has_b = 2 * q + 1 < P
            pp = torch.stack([p0, torch.where(has_b, 2 * q + 1, p0)])
            ok = torch.stack([okq, okq & has_b])   # halves whose results are stored
            top, anchored = b == lx1 - 1, (b + 1) % bpc == 0 or b == lx1 - 1
            c0, w = c0s[t], widths[t]
            L = own[t]
            xu = [xt[b + 1, c][pp] for c in range(C)]
            xd = [xt[b, c][pp] for c in range(C)]
            if top:
                assert L["gb"] == ("reset", r) and L["zhu"] == ("reset", r), \
                    "a couple started from another couple's adjoint row"
            else:
                assert L["gb"] == L["zhu"] == (r, b + 1), "gb or zhu from another unit"
            if anchored:  # the lane's span of the bf16-rounded checkpoint row
                for j in range(M * w):
                    kb[t][j] = ck[b // bpc, M * c0 + j][pp].to(BF)
            else:
                assert L["kb"] == (r, b + 1), "kb from another unit"
            if t == g - 1:  # the pipeline's start at the fp32 right edge
                kr0 = [rc[b, M - 1 - s][pp].to(BF) for s in range(M)]
                if anchored:
                    k0r = ck[b // bpc, G][pp].to(BF)
                else:
                    assert L["kbG"] == (r, b + 1)
                    k0r = kbG[t]
                g0r = zero16
                sig = [kr0[s] - (k0r if s == 0 else kr0[s - 1]) for s in range(M)]
                rho, pK, pG = [zero16] * M, list(kr0), [zero16] * M
                kbG[t], L["kbG"] = kr0[M - 1], (r, b)
                S = [_state0(shape[1:], C) for _ in range(2)]
                for i in range(2):
                    S[i]["gu"] = gst[b + 1, ly1, pp[i]]
                    S[i]["gd"] = gst[b, ly1, pp[i]]
                zh_r = None
            else:
                tag, st = hand[t]
                assert tag == (r, b), "lane t took another unit's state"
                rho, sig, pK, pG, k0r, g0r, zh_r, S = st
                rho, sig, pK, pG = list(rho), list(sig), list(pK), list(pG)
            seed = torch.stack([gout[pp[0]], torch.where(has_b, gout[pp[1]], 0.0)]).to(BF)
            for kk in reversed(range(w)):
                cc = c0 + kk
                gu_l = torch.stack([gst[b + 1, cc, pp[i]] for i in range(2)])
                gd_l = torch.stack([gst[b, cc, pp[i]] for i in range(2)])
                gu_r = torch.stack([S[i]["gu"] for i in range(2)])
                gd_r = torch.stack([S[i]["gd"] for i in range(2)])
                zc = ((((gu_r - gu_l) - gd_r) + gd_l) * ZS * 0.5).to(BF)
                zr = zc if cc == ly1 - 1 else zh_r
                zu = zhu[t][kk]
                zhu[t][kk] = zc
                s1 = [None] * M
                for tt in reversed(range(M)):
                    jn = cc * M + tt
                    kin, gin = kb[t][kk * M + tt], gb[t][kk * M + tt]
                    kin_r, gin_r = k0r, g0r
                    k0r, g0r = kin, gin
                    z1 = zr if tt == M - 1 else zc
                    for s in range(M):
                        rho[s] = (rho[s] + z1 * gin_r) + (zu if s == 0 else zc) * gin
                        if s == 0 and top and jn == G - 1:
                            rho[s] = rho[s] + seed
                        gg = gin + rho[s]
                        sm = kin + kin_r
                        m1 = sm + sig[s]
                        s1[s] = gg * m1 if tt == M - 1 else s1[s] + gg * m1
                        sig[s] = sig[s] + zc * sm
                        if jn == 0:
                            sig[s] = zero16
                        kus = kin + sig[s]
                        kin_r, gin_r = pK[s], pG[s]
                        pK[s], pG[s] = kus, gg
                        kin, gin = kus, gg
                    kb[t][kk * M + tt] = kin
                    gb[t][kk * M + tt] = gin
                for i in range(2):
                    d = s1[0][i].float() * 0.5
                    for s in range(1, M):
                        d = d + s1[s][i].float() * 0.5
                    dz.put((b, cc, pp[i]), d, ok[i])
                    yv = [yt[cc + 1, c, pp[i]] for c in range(C)]
                    E = (d - S[i]["dz"]) * ZS
                    _pull(E, S[i], yv, _Slot(dys[t][kk + 1], i), [x[i] for x in xu],
                          [x[i] for x in xd])
                    S[i]["dz"] = d
                    S[i]["gu"], S[i]["gd"] = gu_l[i], gd_l[i]
                zh_r = zc
            L["kb"] = L["gb"] = L["zhu"] = (r, b)
            if t == 0:  # node column 0 and the band's row-path gradients
                for i in range(2):
                    y0 = [yt[0, c, pp[i]] for c in range(C)]
                    _pull(-S[i]["dz"] * ZS, S[i], y0, _Slot(dys[t][0], i),
                          [x[i] for x in xu], [x[i] for x in xd])
                    for c in range(C):
                        xuc, xdc = xu[c][i], xd[c][i]
                        dx.put((b + 1, c, pp[i]), carry[t][c][i] + 2.0 * (
                            xuc * S[i]["swu"] - S[i]["sxu"][c]), ok[i])
                        cr = carry[t][c].clone()
                        cr[i] = 2.0 * (xdc * S[i]["swd"] - S[i]["sxd"][c])
                        carry[t][c] = cr
                        if b == 0:
                            dx.put((0, c, pp[i]), carry[t][c][i], ok[i])
            if b == 0:  # the couple's end: the column-path gradients it owns
                for s in range(0 if t == 0 else 1, w + 1):
                    for c in range(C):
                        for i in range(2):
                            dy.put((c0 + s, c, pp[i]), dys[t][s][c][i], ok[i])
                dys[t] = [[torch.zeros(shape)] * C for _ in range(w + 1)]
                gb[t] = [zero16] * (M * w)
                zhu[t] = [zero16] * w
                carry[t] = [torch.zeros(shape)] * C
                L["gb"] = L["zhu"] = ("reset", r + 1)
            out[t] = ((r, b), (rho, sig, pK, pG, k0r, g0r, zh_r, S))
        hand = out[1:] + [None]
    for what in (dz, dx, dy):
        assert (what.count == 1).all(), "an output entry written twice or never"
    return dz.value, dx.value, dy.value


def backward_model(xt, yt, ck, rc, gout, sms=kf.SMS, g=None):
    """``(dz·ZS, dx, dy)`` by K4's backward lane schedule from the forward's
    residuals, at the plan's lanes or at ``g`` lanes a pair (the plan's runs,
    ``128/g`` groups a tile)."""
    Lx, C, P = xt.shape
    Ly = yt.shape[0]
    lx1, ly1 = Lx - 1, Ly - 1
    plan = kf.fused_plan(P, lx1, ly1, C, "backward", sms=sms)
    if g is not None and g != plan.g:
        tc = kf.THREADS // g
        plan = SimpleNamespace(g=g, spans=kf.fused_spans(ly1, g), tile_rows=plan.tile_rows,
                               tile_cols=tc, tiles=-(-P // (plan.tile_rows * tc)))
    g, R = plan.g, plan.tile_rows
    G = M * ly1
    bpc = kf._bands_per_ck(lx1)
    c0s = [t * ly1 // g for t in range(g)]
    widths = list(plan.spans)
    gst = kf.pair_statics(xt, yt)[0]
    pidx, live = _groups(plan, P)
    n = pidx[0].numel()
    zero, one = torch.zeros(n), torch.ones(n)
    dinc_all = Writes((lx1, ly1, P))
    dx, dy = Writes((Lx, C, P)), Writes((Ly, C, P))
    U = R * lx1
    # what each lane owns, with the unit that last wrote it
    kb, lam, gs, ys = [None] * g, [None] * g, [None] * g, [None] * g
    kbG = [None] * g
    own = [{"kb": None, "lam": None, "gs": None, "kbG": None} for _ in range(g)]
    dys = [[[zero] * C for _ in range(w + 1)] for w in widths]
    carry = [[zero] * C for _ in range(g)]
    hand = [None] * g
    for k in range(U + g - 1):
        out = [None] * g
        for t in range(g):
            u = k - (g - 1 - t)
            if not (0 <= u < U and live[u // lx1]):
                continue
            r = u // lx1
            b = lx1 - 1 - (u - r * lx1)
            p = pidx[r]
            ok = p < P
            pc = torch.where(ok, p, 0)
            top, anchored = b == lx1 - 1, (b + 1) % bpc == 0 or b == lx1 - 1
            c0, w = c0s[t], widths[t]
            L = own[t]
            xu = [xt[b + 1, c, pc] for c in range(C)]
            xd = [xt[b, c, pc] for c in range(C)]
            if anchored:  # the lane's span of the checkpoint row
                kb[t] = [ck[b // bpc, M * c0 + j, pc] for j in range(M * w)]
            else:
                assert L["kb"] == (r, b + 1), "kb from another unit"
            if top:  # a pair's first unit: the span's y points, static row lx1
                ys[t] = [[yt[c0 + q, c, pc] for c in range(C)] for q in range(w + 1)]
                gs[t] = [gst[b + 1, c0 + q, pc] for q in range(w + 1)]
                lam[t] = [None] * (M * w)
                sd = gout[pc]
            else:
                assert L["gs"] == L["lam"] == (r, b + 1), "gs or lam from another unit"
            gd = [gst[b, c0 + q, pc] for q in range(w + 1)]   # one exp a node
            if t == g - 1:  # the pipeline's start at the right edge
                pv = [rc[b, s, pc] for s in range(M)]
                if anchored:
                    pv.append(ck[b // bpc, G, pc])
                else:
                    assert L["kbG"] == (r, b + 1), "k[8b+8][G] from another unit"
                    pv.append(kbG[t])
                kbG[t], L["kbG"] = pv[0], (r, b)
                lm = [zero] * (M + 1)
                Ar = Br = dinc_r = zero
                S = _state0((n,), C)
            else:
                tag, st = hand[t]
                assert tag == (r, b), "lane t took another unit's state"
                lm, pv, Ar, Br, dinc_r, S = st
                lm, pv = list(lm), list(pv)
            for kk in reversed(range(w)):
                cc = c0 + kk
                z = (((gs[t][kk + 1] - gs[t][kk]) - gd[kk + 1]) + gd[kk]) * ZS
                A, B = kf._coef(z)
                Bi = 1.0 / B
                s1 = s2 = zero
                for tt in reversed(range(M)):
                    i, j = kk * M + tt, cc * M + tt + 1
                    ar, br = (Ar, Br) if tt == M - 1 else (A, B)
                    if top:
                        lt = torch.where(torch.tensor(j == G), sd, zero)
                    else:
                        lt = lam[t][i]
                    ln = [None] * (M + 1)
                    ln[M] = _fma(lm[M], ar, lt)
                    for s in range(M - 1, 0, -1):
                        ln[s] = _fma(lm[s], ar, _fma(ln[s + 1], A, -(lm[s + 1] * br)))
                    if b > 0:  # the band below's part of row 8b's adjoint
                        lam[t][i] = _fma(ln[1], A, -(lm[1] * br))
                    pn, h = [None] * (M + 1), [None] * M
                    pn[M] = kb[t][i]
                    for s in range(M - 1, -1, -1):
                        h[s] = pn[s + 1] + pv[s]
                        pn[s] = _fma(h[s], A, -pv[s + 1]) * Bi
                    if b == 0:
                        pn[0] = one
                    if j == 1:  # node column 0 is one
                        pn = [one] * (M + 1)
                        h = [one + pv[s] for s in range(M)]
                    kb[t][i] = pn[0]
                    for s in range(M):
                        s1 = _fma(ln[s + 1], h[s], s1)
                        s2 = _fma(ln[s + 1], pn[s], s2)
                    pv, lm = pn, ln
                t1 = z * (1.0 / 6.0)
                dinc = _fma(0.5 + t1, s1, t1 * s2) * ZS
                dinc_all.put((b, cc, p), dinc, ok)
                _pull(dinc - dinc_r, S, ys[t][kk + 1], dys[t][kk + 1], xu, xd,
                      gs[t][kk + 1], gd[kk + 1])
                dinc_r, Ar, Br = dinc, A, B
            if t == 0:  # node column 0 and the band's row-path gradients
                _pull(-dinc_r, S, ys[t][0], dys[t][0], xu, xd, gs[t][0], gd[0])
                for c in range(C):
                    dx.put((b + 1, c, p), carry[t][c] + 2.0 * (xu[c] * S["swu"] - S["sxu"][c]),
                           ok)
                    carry[t][c] = 2.0 * (xd[c] * S["swd"] - S["sxd"][c])
                    if b == 0:
                        dx.put((0, c, p), carry[t][c], ok)
            gs[t] = gd
            L["kb"] = L["lam"] = L["gs"] = (r, b)
            if b == 0:  # the pair's end: the column-path gradients it owns
                for q in range(0 if t == 0 else 1, w + 1):
                    for c in range(C):
                        dy.put((c0 + q, c, p), dys[t][q][c], ok)
                dys[t] = [[zero] * C for _ in range(w + 1)]
                carry[t] = [zero] * C
            out[t] = ((r, b), (lm, pv, Ar, Br, dinc_r, S))
        hand = out[1:] + [None]
    for what in (dinc_all, dx, dy):
        assert (what.count == 1).all(), "an output entry written twice or never"
    return dinc_all.value, dx.value, dy.value


class _Slot:
    """One pair's half of a lane's column-path gradient slots ``[C][2, NG]``."""

    def __init__(self, slots, i):
        self.slots, self.i = slots, i

    def __getitem__(self, c):
        return self.slots[c][self.i]

    def __setitem__(self, c, v):
        cur = self.slots[c].clone()
        cur[self.i] = v
        self.slots[c] = cur


def _tiles(rng, P, Lx, Ly, C):
    """Scaled tiles of ``P`` random pairs of joint-angle-like paths at h = 4
    (cumulative steps of at most 0.1, × 0.5)."""
    X = np.cumsum((rng.random((16, Lx, C)) - 0.5) * 0.2, 1) * 0.5
    Y = np.cumsum((rng.random((16, Ly, C)) - 0.5) * 0.2, 1) * 0.5
    ix, iy = rng.integers(0, 16, P), rng.integers(0, 16, P)
    xt = torch.from_numpy(X[ix].transpose(1, 2, 0).astype(np.float32)).contiguous()
    yt = torch.from_numpy(Y[iy].transpose(1, 2, 0).astype(np.float32)).contiguous()
    return xt, yt, torch.from_numpy(rng.standard_normal(P).astype(np.float32))


@pytest.mark.parametrize("P,Lx,Ly,C,sms", [
    (37, 4, 5, 1, kf.SMS),     # g = 1, lx1 = 3 < 6: one checkpoint slot
    (21, 8, 10, 4, kf.SMS),    # g = 2, ly1 = 9 not a multiple of g, lx1 = 7: slots 6 + 1
    (41, 6, 18, 2, 1),         # g = 4, ly1 = 17, runs of 8 pairs (three live)
    (9, 3, 34, 1, kf.SMS),     # g = 8, spans of 4 and 5
    (5, 14, 49, 4, kf.SMS),    # g = 16, ly1 = 48, three slots (6 + 6 + 1)
], ids=["g1", "g2_ly9", "g4_runs", "g8", "g16_ly48"])
def test_forward_schedule_matches_the_twin(rng, P, Lx, Ly, C, sms):
    """k, ck and rc bit-equal to ``fused_forward_plain``: a schedule does
    not change a node's arithmetic, and the static row carried from one
    band to the next is the one the twin forms."""
    xt, yt, _ = _tiles(rng, P, Lx, Ly, C)
    k, ck, rc = forward_model(xt, yt, sms)
    kp, ckp, rcp = kf.fused_forward_plain(xt, yt, residuals=True)
    assert torch.equal(k, kp) and torch.equal(ck, ckp) and torch.equal(rc, rcp)


@pytest.mark.parametrize("P,Lx,Ly,C,sms", [
    (37, 4, 5, 1, kf.SMS),     # g = 1, lx1 = 3, odd P: the last couple a lone pair
    (21, 8, 10, 4, kf.SMS),    # g = 2, ly1 = 9, lx1 = 7 (slots 6 + 1), odd P
    (81, 6, 18, 2, 1),         # g = 4, ly1 = 17, runs of 8 couples (two live), lone pair
    (8, 3, 34, 3, kf.SMS),     # g = 8, ly1 = 33, Lx ≠ Ly
    (5, 8, 41, 4, kf.SMS),     # g = 8, ly1 = 40, the bf16 envelope's edge
], ids=["g1", "g2_ly9", "g4_runs", "g8", "g8_ly40"])
def test_bf16_schedule_matches_the_twin(rng, P, Lx, Ly, C, sms):
    """Every coarse cell's dz bit-equal to the twin's; dx and dy, scaled by
    their max, within 1e-5 of the twin's (the fp32 pull-back sums run in
    another order; the largest seen at these cases is 4.6e-7)."""
    xt, yt, gout = _tiles(rng, P, Lx, Ly, C)
    _, ck, rc = kf.fused_forward_plain(xt, yt, residuals=True)
    dz, dx, dy = bf16_model(xt, yt, ck, rc, gout, sms)
    _, dzp = kf.bf16_dz(xt, yt, ck, rc, gout)
    assert torch.equal(dz, dzp)
    dxp, dyp = kf.fused_backward_bf16_plain(xt, yt, ck, rc, gout)
    for got, want in ((dx, dxp), (dy, dyp)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= 1e-5, err


@pytest.mark.parametrize("P,Lx,Ly,C,sms", [
    (37, 4, 5, 1, kf.SMS),     # g = 1, lx1 = 3 < 6: one checkpoint slot, odd P
    (21, 8, 10, 4, kf.SMS),    # g = 2, ly1 = 9, lx1 = 7: slots 6 + 1, odd P
    (41, 6, 18, 2, 1),         # g = 4, ly1 = 17, runs of 8 pairs (six live), odd P
    (9, 3, 34, 8, kf.SMS),     # g = 8, spans of 4 and 5, C = 8, Lx ≠ Ly
    (3, 9, 49, 8, kf.SMS),     # g = 16, ly1 = 48 (spans of 3), C = 8, slots 6 + 2
], ids=["g1", "g2_ly9", "g4_runs", "g8_c8", "g16_ly48_c8"])
def test_backward_schedule_holds_the_twins(rng, P, Lx, Ly, C, sms):
    """dx and dy, scaled by their max, within K4's atol 4e-4 of the twin in
    fp32 and in fp64 (``chip_smoke.K4_TOL``): the rebuild toward -j from
    carried band tops drifts from the exact grid by rounding alone; the
    largest seen at these cases was 4.8e-5 against fp64."""
    xt, yt, gout = _tiles(rng, P, Lx, Ly, C)
    _, ck, rc = kf.fused_forward_plain(xt, yt, residuals=True)
    _, dx, dy = backward_model(xt, yt, ck, rc, gout, sms)
    dxp, dyp = kf.fused_backward_plain(xt, yt, gout)
    _, dx64, dy64 = kf.fused_pairs_plain(xt.double(), yt.double(), gout.double())
    assert torch.isfinite(dx).all() and torch.isfinite(dy).all()
    for got, want in ((dx, dxp), (dy, dyp), (dx, dx64), (dy, dy64)):
        err = ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()
        assert err <= 4e-4, err


@pytest.mark.parametrize("P,Lx,Ly,C,sms", [
    (41, 6, 18, 2, 1),         # 4 lanes a pair against 1, runs of 8 pairs
    (7, 3, 34, 3, kf.SMS),     # 8 lanes a pair against 1
], ids=["g4_runs", "g8"])
def test_backward_schedule_is_the_one_lane_sweep(rng, P, Lx, Ly, C, sms):
    """A pair's lanes split its columns, not its arithmetic: every coarse
    cell's dz and dx, dy are bit-equal to the one-lane schedule's (each
    node's chain and each sum in the same order)."""
    xt, yt, gout = _tiles(rng, P, Lx, Ly, C)
    _, ck, rc = kf.fused_forward_plain(xt, yt, residuals=True)
    got = backward_model(xt, yt, ck, rc, gout, sms)
    one = backward_model(xt, yt, ck, rc, gout, sms, g=1)
    for a, b in zip(got, one):
        assert torch.equal(a, b)


def test_plan_at_the_flagship_list():
    """524,800 pairs of 40-point paths (39 × 39 coarse cells): 8 lanes a pair
    (K6: a couple) over spans of 4-5 coarse columns, runs of 8, tiles of
    128 pairs (256), persistent over the resident blocks (the backward's
    two an SM: 16 passes); the traffic is the bound's bytes, no fine row
    through device memory; K6's checkpoint loads fill whole sectors (8
    adjacent pairs a lane position), the forward's stores and the fp32
    backward's loads half sectors (4)."""
    P = 524_800
    fwd = kf.fused_plan(P, 39, 39, 2, "forward", resident=132 * 4)
    bwd = kf.fused_plan(P, 39, 39, 2, "backward", resident=132 * 2)
    k6 = kf.fused_plan(P, 39, 39, 2, "bf16", resident=132 * 2)
    for plan in (fwd, bwd, k6):
        assert (plan.g, plan.span, plan.spans) == (8, 5, (4, 5, 5, 5, 5, 5, 5, 5))
        assert (plan.tile_rows, plan.tile_cols, plan.steps) == (8, 16, 8 * 39 + 7)
        assert plan.scratch_bytes == 0
    assert (fwd.pairs_per_tile, fwd.tiles, fwd.blocks, fwd.passes) == (128, 4100, 528, 8)
    assert (k6.pairs_per_tile, k6.tiles, k6.blocks, k6.passes) == (256, 2050, 264, 8)
    assert (bwd.pairs_per_tile, bwd.tiles, bwd.blocks, bwd.passes) == (128, 4100, 264, 16)
    assert bwd.smem_bytes == 4 * 128 * (2 * 6 * 2 + 40 + 9 + 4)
    assert bwd.traffic_bytes == {"backward": kf.fused_bytes(P, 40, 40, 2, "backward")}
    assert bwd.sector_share == 0.0
    assert fwd.smem_bytes == 4 * 128 * 6 * 2
    assert k6.smem_bytes == 4 * 128 * (4 * 6 * 2 + 80 + 18 + 8)
    assert fwd.traffic_bytes == {"forward": kf.fused_bytes(P, 40, 40, 2),
                                 "values": 4.0 * (P * 80 * 2 + P)}
    assert k6.traffic_bytes == {"bf16": kf.fused_bytes(P, 40, 40, 2, "bf16")}
    assert 5.5e9 < fwd.traffic_bytes["forward"] < 5.7e9
    assert fwd.sector_share == 0.0 and k6.sector_share == 1.0


@pytest.mark.parametrize("P", [200, 201])
def test_plan_spreads_a_short_list(P):
    """The tests' lists: runs of one pair (couple), so the list spreads over
    as many blocks as a group a pair gives; an odd P leaves a lone pair."""
    for ly1, part, g, tiles in ((39, "forward", 8, -(-P // 16)), (39, "bf16", 8, -(-P // 32)),
                                (8, "bf16", 2, -(-P // 128)), (4, "forward", 1, 2),
                                (48, "backward", 16, -(-P // 8)), (5, "backward", 1, 2)):
        plan = kf.fused_plan(P, 5, ly1, 2, part)
        assert (plan.g, plan.tile_rows, plan.tiles, plan.blocks) == (g, 1, tiles, tiles)
        assert plan.tiles * plan.pairs_per_tile >= P
        assert plan.steps == 5 + g - 1


def test_plan_envelope():
    """Every shape the kernels take: the spans cover ly1 once, at most 5 a
    lane; a block's shared memory within Hopper's 232,448 B; the backwards
    two blocks an SM (8 warps), the forward three."""
    for part, max_ly1, max_c, per_sm in (("forward", 48, 8, 3), ("backward", 48, 8, 2),
                                         ("bf16", 40, 4, 2)):
        for ly1 in range(1, max_ly1 + 1):
            for C in range(1, max_c + 1):
                plan = kf.fused_plan(1000, 7, ly1, C, part)
                assert sum(plan.spans) == ly1 and len(plan.spans) == plan.g
                assert 1 <= min(plan.spans) and max(plan.spans) <= plan.span <= kf.SPAN_CAP
                assert plan.g * plan.tile_cols == kf.THREADS
                assert plan.smem_bytes <= 232_448
                assert per_sm * (plan.smem_bytes + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="part"):
        kf.fused_plan(10, 5, 5, 2, "sideways")


def test_sector_share_counts_whole_aligned_sectors():
    # 8 floats a row, pieces of 8 pairs: every access one aligned sector
    assert kf._sector_share(8, 3, 8) == 1.0
    # pieces of 4 pairs (16 B): no whole sector
    assert kf._sector_share(64, 5, 4) == 0.0
    # P = 12, pieces of 8 pairs: row 0 (bytes [0, 48)) moves [0, 32), a whole
    # sector, and [32, 48); row 1 starts at byte 48, so [48, 80) and [80, 96)
    # each straddle a sector boundary: 32 of 96 bytes in whole sectors
    assert kf._sector_share(12, 2, 8) == pytest.approx(32 / 96)
