"""K5's lane schedule (``csrc/sigkernel_tiled.cu``) modelled on the CPU.

The model runs what each lane of a group does, step by step, vectorised
over the groups of all tiles: the spans of :func:`tiled_lanes` /
:func:`tiled_spans`; the forward pipeline (lane t sweeps band ``k - t`` of
its group's pairs with the twin's fused ``_fma`` and hands its right-edge
values and corner to lane t+1), writing its span of each checkpoint band's
top row into the lanes' layout of the checkpoints; the backward's two
pipelines: the rebuild pipeline (lane t rebuilds unit ``k - t`` toward +j
from its top row and the left-edge column lane t-1 hands it, keeps that
column in its ring of ``2g - 2t`` slots and hands its right edge on) and the
adjoint pipeline right to left (lane t takes unit ``k - (2g-1-t)``, reads
the unit's left edge from its ring, rebuilds its span again for each coarse
cell's left column, then walks the cells right to left: the cell's nodes
rebuilt, the adjoint, dz written, and the adjoint column with the
coefficients beside it handed to lane t-1). Tags prove that each lane reads
only what it was meant to: the hand-offs carry their unit, each ring slot
and each checkpoint float its writer's unit or (pair, slot, column); the
primal rows of the two pipelines agree bit for bit; each coarse cell's dz
is written once, by the lane whose span holds it. A schedule does not
change a node's arithmetic, so k is bit-equal to the twin's and the
checkpoints, converted by :func:`twin_checkpoints`, equal the twin's; dz is
held against the fp32 twin and the fp64 twin at K5's tolerance (scaled atol
5e-4, ``tests/test_pallas_sigkernel.py``). The plan (:func:`tiled_plan`) is
held to the flagship list's layout and memory.
"""
import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt
from sigsvgd_tpu_torch.kernels.sigkernel_fused import _fma

M = 8
I6 = 1.0 / 6.0


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The model runs tens of thousands of ops on tensors of a few hundred
    floats: on one thread, not beside the JAX runtime's threads (~50× faster
    here); the thread count is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coef(zv):
    A, B = kt.coefs(zv)
    return A, B, 1.0 / A


def _rebuild(kl, here, hl, B, Ai):
    return _fma(_fma(kl, B, here), Ai, -hl)


def _ck_f4(i, c0, q, ngw):
    """Float4 i of a lane's span in its block (csrc ``CkLayout::f4``)."""
    return (2 * c0 + i) * ngw + q


def schedule_model(z: torch.Tensor, gout: torch.Tensor):
    """``(k, ck, dz)`` by K5's lane schedule on ``z [lx1, ly1, P]``; ``ck`` in
    the kernel's layout."""
    lx1, ly1, P = z.shape
    plan = kt.tiled_plan(P, lx1, ly1)
    g, tc, R = plan.g, plan.tile_cols, plan.tile_rows
    G = M * ly1
    bpc = kt._bands_per_ck(lx1)
    nslots = plan.nslots
    c0s = [t * ly1 // g for t in range(g)]
    widths = list(plan.spans)
    ngw = 32 // g
    block_f4 = ngw * 2 * ly1
    NGtot = plan.tiles * tc
    grp = torch.arange(NGtot)
    tile, gi = grp // tc, grp % tc
    warp, q = gi // ngw, gi % ngw
    # the pairs of pipeline position r, one per group; padding pairs have z = 0
    pidx = [tile * plan.pairs_per_tile + r * tc + gi for r in range(R)]
    live = [bool((p < P).any()) for p in pidx]
    Ppad = plan.tiles * plan.pairs_per_tile
    zp = torch.cat([z, z.new_zeros(lx1, ly1, Ppad - P)], -1)
    gp = torch.cat([gout, gout.new_zeros(Ppad - P)])
    one, zero = torch.ones(NGtot), torch.zeros(NGtot)
    U = R * lx1

    def ck_offsets(t, r, slot, i):
        """Float offsets [4, NGtot] of float4 i of lane t's span (all groups)."""
        f4 = _ck_f4(i, c0s[t], q, ngw)
        base = (((tile * nslots + slot) * (kt.THREADS // 32) + warp) * R + r) * block_f4
        return (base + f4)[None] * 4 + torch.arange(4)[:, None]

    # ---- forward -------------------------------------------------------
    ck = torch.full((plan.ck_floats,), float("nan"))
    ck_tag = torch.full((plan.ck_floats,), -1, dtype=torch.int64)
    kval = torch.empty(Ppad)
    row = [[one] * (M * w) for w in widths]
    hand = [None] * g
    for k in range(U + g - 1):
        out = [None] * g
        for t in range(g):
            u = k - t
            if not (0 <= u < U and live[u // lx1]):
                continue
            r, b = divmod(u, lx1)
            p = pidx[r]
            if b == 0:
                row[t] = [one] * (M * widths[t])
            if t == 0:
                left, corner = [one] * M, [one] * M
            else:
                tag, in_left, in_corner = hand[t]
                assert tag == u, "lane t took another unit's carries"
                left, corner = list(in_left), [in_corner] + list(in_left[:M - 1])
            keep = (b + 1) % bpc == 0 or b == lx1 - 1
            for kk in range(widths[t]):
                cj = c0s[t] + kk
                A, B, _ = _coef(zp[b, cj, p])
                for tt in range(M):
                    up = row[t][kk * M + tt]
                    for s in range(M):
                        kn = _fma(left[s] + up, A, -(corner[s] * B))
                        corner[s], left[s], up = up, kn, kn
                    row[t][kk * M + tt] = up
                if keep:
                    for h in range(2):
                        off = ck_offsets(t, r, b // bpc, 2 * kk + h)
                        ok = p < P
                        assert (ck_tag[off[:, ok]] == -1).all(), "a checkpoint float written twice"
                        vals = torch.stack(row[t][kk * M + 4 * h:kk * M + 4 * h + 4])
                        ck[off[:, ok]] = vals[:, ok]
                        col = cj * M + 4 * h + 1 + torch.arange(4)[:, None]
                        ck_tag[off[:, ok]] = ((p[None] * nslots + b // bpc) * (G + 1) + col)[:, ok]
            if t == g - 1 and b == lx1 - 1:
                kval[p] = left[M - 1]
            out[t] = (u, list(left), corner[0])
        hand = [None] + out[:-1]

    # ---- backward ------------------------------------------------------
    def load_top(t, r, b):
        p = pidx[r]
        vals = []
        for kk in range(widths[t]):
            for h in range(2):
                off = ck_offsets(t, r, b // bpc, 2 * kk + h)
                col = (c0s[t] + kk) * M + 4 * h + 1 + torch.arange(4)[:, None]
                want = (p[None] * nslots + b // bpc) * (G + 1) + col
                ok = p < P
                assert torch.equal(ck_tag[off[:, ok]], want[:, ok]), \
                    "a lane read a checkpoint another lane or pair wrote"
                vals.extend(ck[off])
        return vals

    dz = torch.full((lx1, ly1, Ppad), float("nan"))
    owner = torch.full((lx1, ly1), -1, dtype=torch.int64)
    writes = torch.zeros(lx1, ly1, R, dtype=torch.int64)
    row1 = [None] * g                                     # the rebuild's top rows
    row2 = [None] * g                                     # the adjoint's top rows
    lam = [[zero] * (M * w) for w in widths]
    zu = [None] * g
    rings = [dict() for _ in range(g)]
    reb_bottom = {}                                       # (t, u): the rebuild's bottom row
    in1, in2 = [None] * g, [None] * g
    for k in range(U + 2 * g - 1):
        out1, out2 = [None] * g, [None] * g
        for t in range(g):
            # 1. the rebuild pipeline, left to right
            u = k - t
            if 0 <= u < U and live[u // lx1]:
                r, s_ = divmod(u, lx1)
                b = lx1 - 1 - s_
                p = pidx[r]
                if b == lx1 - 1 or (b + 1) % bpc == 0:
                    row1[t] = load_top(t, r, b)
                if t == 0:
                    prev = [one] * (M + 1)
                else:
                    tag, prev = in1[t]
                    assert tag == u, "the rebuild's left edge came from another unit"
                    Q = 2 * g - 2 * t
                    assert u % Q not in rings[t], "a ring slot overwritten before it was read"
                    rings[t][u % Q] = (u, list(prev))
                for kk in range(widths[t]):
                    _, B, Ai = _coef(zp[b, c0s[t] + kk, p])
                    for tt in range(M):
                        cur = [None] * (M + 1)
                        cur[M] = row1[t][kk * M + tt]
                        for s in range(M - 1, -1, -1):
                            cur[s] = _rebuild(prev[s], cur[s + 1], prev[s + 1], B, Ai)
                        row1[t][kk * M + tt] = cur[0]
                        prev = cur
                reb_bottom[t, u] = list(row1[t])
                out1[t] = (u, prev)
            # 2. the adjoint pipeline, right to left
            u = k - (2 * g - 1 - t)
            if 0 <= u < U and live[u // lx1]:
                r, s_ = divmod(u, lx1)
                b = lx1 - 1 - s_
                top = b == lx1 - 1
                p = pidx[r]
                if top or (b + 1) % bpc == 0:
                    row2[t] = load_top(t, r, b)
                if t == 0:
                    edge = [one] * (M + 1)
                else:
                    tag, edge = rings[t].pop(u % (2 * g - 2 * t))
                    assert tag == u, "a ring slot held another unit's left edge"
                zc = [zp[b, c0s[t] + kk, p] for kk in range(widths[t])]
                # (i) each cell's left column
                lefts, prev = [edge], edge
                for kk in range(widths[t] - 1):
                    _, B, Ai = _coef(zc[kk])
                    for tt in range(M):
                        cur = [None] * (M + 1)
                        cur[M] = row2[t][kk * M + tt]
                        for s in range(M - 1, -1, -1):
                            cur[s] = _rebuild(prev[s], cur[s + 1], prev[s + 1], B, Ai)
                        prev = cur
                    lefts.append(prev)
                # (ii) cells right to left
                if t == g - 1:
                    gR, lamR, Ar, Br, Bur = [zero] * (M + 1), zero, zero, zero, zero
                else:
                    tag, (gR, lamR, Ar, Br, Bur) = in2[t]
                    assert tag == u, "the adjoint's right edge came from another unit"
                    gR = list(gR)
                for kk in reversed(range(widths[t])):
                    cc = c0s[t] + kk
                    A, B, Ai = _coef(zc[kk])
                    Au, Bu = (zero, zero) if top else kt.coefs(zu[t][kk])
                    K = [[None] * (M + 1) for _ in range(M + 1)]
                    for s in range(M):
                        K[s][0] = lefts[kk][s]
                    K[M][0] = row2[t][kk * M - 1] if kk else edge[M]
                    for c in range(1, M + 1):
                        K[M][c] = row2[t][kk * M + c - 1]
                    for c in range(1, M + 1):
                        for s in range(M - 1, -1, -1):
                            K[s][c] = _rebuild(K[s][c - 1], K[s + 1][c], K[s + 1][c - 1], B, Ai)
                    if b > 0:
                        for c in range(1, M + 1):
                            row2[t][kk * M + c - 1] = K[0][c]
                    s1 = s2 = zero
                    for c in range(M, 0, -1):
                        j = cc * M + c
                        ar, br, bur = (Ar, Br, Bur) if c == M else (A, B, Bu)
                        lamj = zero if top else lam[t][kk * M + c - 1]
                        gN = [None] * (M + 1)
                        gv = _fma(ar, gR[M], _fma(Au, lamj, -(bur * lamR)))
                        if top and j == G:
                            gv = gv + gp[p]
                        gN[M] = gv
                        for s in range(M - 1, 0, -1):
                            gN[s] = _fma(ar, gR[s], _fma(A, gN[s + 1], -(br * gR[s + 1])))
                        for s in range(M, 0, -1):
                            s1 = _fma(gN[s], K[s][c - 1] + K[s - 1][c], s1)
                            s2 = _fma(gN[s], K[s - 1][c - 1], s2)
                        if b > 0:
                            lam[t][kk * M + c - 1] = gN[1]
                        lamR = lamj
                        gR = gN
                    zs = zc[kk] * I6
                    dz[b, cc, p] = _fma(0.5 + zs, s1, zs * s2)
                    assert owner[b, cc] in (-1, t), "two lanes pulled one cell back"
                    owner[b, cc] = t
                    writes[b, cc, r] += 1
                    Ar, Br, Bur = A, B, Bu
                if b > 0:
                    # the two pipelines rebuilt the same bottom row, bit for bit
                    ok = p < P
                    assert all(torch.equal(x[ok], y[ok])
                               for x, y in zip(row2[t], reb_bottom.pop((t, u))))
                else:
                    reb_bottom.pop((t, u))
                zu[t] = zc
                out2[t] = (u, (gR, lamR, Ar, Br, Bur))
        in1 = [None] + out1[:-1]
        in2 = out2[1:] + [None]
    assert not reb_bottom and not any(rings)
    # each cell's dz written once a pair, by the lane whose span holds it
    spans = torch.repeat_interleave(torch.arange(g), torch.tensor(widths))
    assert torch.equal(owner, spans[None].expand(lx1, ly1))
    live_r = torch.tensor(live)
    assert (writes[..., live_r] == 1).all() and (writes[..., ~live_r] == 0).all()
    return kval[:P], ck, dz[..., :P]


def _increments(rng, P, lx1, ly1, scale=0.3):
    z = (rng.standard_normal((lx1, ly1, P)) * scale / 64.0).astype(np.float32)
    return torch.from_numpy(z), torch.from_numpy(rng.standard_normal(P).astype(np.float32))


@pytest.mark.parametrize("P,lx1,ly1", [
    (37, 4, 3),      # g = 1, two checkpoint segments
    (1100, 1, 5),    # g = 1, one band, one full tile and a part of the next
    (150, 3, 9),     # g = 2
    (70, 7, 13),     # g = 4, rectangular, two segments (6 + 1 bands)
    (40, 2, 33),     # g = 8, spans of 4 and 5
    (20, 13, 39),    # g = 8, the flagship's spans, three segments (6 + 6 + 1)
    (30, 1, 48),     # g = 16, one band
], ids=["g1", "g1_lx1", "g2", "g4_rect", "g8", "g8_ly39", "g16_lx1"])
def test_lane_schedule_matches_the_twin(rng, P, lx1, ly1):
    """No P here is a multiple of a tile (1024/g pairs), so padding pairs
    ride along; the groups walk one to eight pairs (the pipeline's
    hand-overs from one pair to the next) and the checkpoint segments of
    ``bpc = min(6, lx1)``. k and the checkpoints bit-equal to the twin's; dz scaled by
    max|dz| within 5e-4 of the fp32 and the fp64 twin."""
    g, _ = kt.tiled_lanes(ly1)
    assert g == {3: 1, 5: 1, 9: 2, 13: 4, 33: 8, 39: 8, 48: 16}[ly1]
    z, gout = _increments(rng, P, lx1, ly1)
    k, ck, dz = schedule_model(z, gout)
    kp, ckp = kt.tiled_forward_plain(z, with_ck=True)
    assert torch.equal(k, kp)
    assert torch.equal(kt.twin_checkpoints(ck, lx1, ly1, P), ckp)
    dzp = kt.tiled_backward_plain(z, ckp, gout)
    dz64 = kt.tiled_backward_plain(z.double(), kt.tiled_forward_plain(z.double(), True)[1],
                                   gout.double())
    scale = dz64.abs().max()
    assert ((dz.double() - dz64).abs().max() / scale).item() <= 5e-4
    assert ((dz - dzp).abs().max() / scale).item() <= 5e-4


def test_plan_spans_cover_every_coarse_column_once():
    for ly1 in range(1, kt.MAX_LY1 + 1):
        g, span = kt.tiled_lanes(ly1)
        widths = kt.tiled_spans(ly1, g)
        assert g & (g - 1) == 0 and g <= 16 and len(widths) == g
        assert sum(widths) == ly1 and min(widths) >= 1
        assert max(widths) <= span <= kt.SPAN_CAP and span in kt.SPAN_TEMPLATES
        # the fewest lanes that keep every span within the cap
        assert g == 1 or -(-ly1 // (g // 2)) > kt.SPAN_CAP
        plan = kt.tiled_plan(1000, 7, ly1)
        assert plan.tile_cols * g == kt.THREADS and plan.spans == tuple(widths)
        # two backward blocks fit an SM's 227 KB of shared memory
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
        # the device checkpoints take 8·ly1 floats a pair and slot (the twin 8·ly1+1)
        assert plan.ck_floats == plan.tiles * plan.pairs_per_tile * plan.nslots * 8 * ly1


def test_layout_maps_each_pair_slot_and_column_to_its_own_float():
    for P, lx1, ly1 in ((1100, 2, 5), (300, 3, 41), (200, 13, 39)):
        plan = kt.tiled_plan(P, lx1, ly1)
        idx = torch.cat([kt._ck_index(P, lx1, ly1, torch.arange(P), s).reshape(-1)
                         for s in range(plan.nslots)])
        assert idx.numel() == P * plan.nslots * 8 * ly1
        assert idx.unique().numel() == idx.numel()
        assert 0 <= idx.min() and idx.max() < plan.ck_floats


def test_plan_at_the_flagship_linear_list():
    """524,800 pairs of 40-point paths (39 × 39 coarse cells): 8 lanes a pair
    over spans of 4-5 coarse columns, tiles of 8 × 16 pairs, 4,100 blocks;
    the checkpoints 7 slots of 312 floats a pair; the traffic formulas of
    ``PERF.md``, far below the ~230 GB a thread-per-pair kernel streams."""
    P = 524_800
    plan = kt.tiled_plan(P, 39, 39, blocks=132 * 2)
    assert (plan.g, plan.span, plan.tile_rows, plan.tile_cols) == (8, 5, 8, 16)
    assert plan.spans == (4, 5, 5, 5, 5, 5, 5, 5)
    assert plan.pairs_per_tile == 128 and plan.tiles == 4100 and plan.nslots == 7
    assert plan.fwd_steps == 8 * 39 + 7 and plan.bwd_steps == 8 * 39 + 15
    assert plan.ring_floats == 8 * 7 * 9 and plan.scratch_bytes == 0
    assert plan.smem_bytes == 4 * 128 * (120 + 32 + 63)
    assert plan.ck_floats == P * 7 * 312
    z, slots = 4.0 * P * 39 * 39, 4.0 * P * 7 * 312
    assert plan.traffic_bytes == {"forward": z + 4.0 * P + slots, "values": z + 4.0 * P,
                                  "backward": 3 * z + 2 * slots + 4.0 * P}
    total = plan.traffic_bytes["forward"] + plan.traffic_bytes["backward"]
    assert 26e9 < total < 27e9
    assert plan.waves == pytest.approx(4100 / 264)


def test_chunk_pair_bytes_holds_the_device_checkpoints():
    """The chunk plan's per-pair bytes count the twin's 8·ly1+1 floats a
    slot, at least the device layout's 8·ly1; the flagship linear list
    stays one chunk in a quarter of an 80 GB card."""
    for lx1, ly1 in ((39, 39), (16, 16), (6, 48), (1, 1)):
        plan = kt.tiled_plan(1 << 20, lx1, ly1)
        per_pair = kt.chunk_pair_bytes(lx1, ly1, 2, "cuda", rbf=False)
        assert 4 * plan.ck_floats / (1 << 20) <= kt.residual_bytes(1, lx1, ly1)
        assert per_pair >= kt.residual_bytes(1, lx1, ly1)
    linear = kt.chunk_pair_bytes(39, 39, 2, "cuda", rbf=False)
    assert linear == 4 * (7 * 313 + 3 * 39 * 39) + 16 * 80 * 2
    assert 524_800 * linear <= 80 * 10**9 // 4
