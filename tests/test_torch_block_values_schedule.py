"""K3's band wavefront (``csrc/sigkernel_block.cu`` ``block_values_kernel``)
as a step-by-step CPU model of one thread's pair, without JAX.

The model stages the pair's paths as the kernel does (pre-scaled, -½|·|² in
channel order, the column path padded to the length bucket by repeating node
L-1), keeps the band's bottom K row and static row over the bucket's
columns, and sweeps each band of R cell rows as the kernel's skewed
wavefront: at step t the column point t+1 is loaded once and its static node
formed for every band row, the bottom static row's node t+1 read and then
replaced by the top row's in place (the kernel keeps that row in shared
memory), then band row s updates cell (i0 + s, t - s), taking its left
values from its own row and its lower ones from row s-1 (the bottom rows for
s = 0); rows past L-2 in the last band run on node row L-1
and copy the row below; the band's top rows replace the bottom ones; K is
read at node L-1 of the last top row. Each value is written once and read
only after it is written (asserted through ``None`` placeholders), every kept
cell of the (L-1)² grid is updated exactly once, and K is the twin's
(``block_gram_plain``) bit for bit, at R = 2, 4 and 8, L = 2, 5, 40, 41 and
64 (partial last bands among them), C = 1, 3 and 8 with L·C ≤ 128. The
plan's counts, the kernel's band rows and its instantiations are checked
against the source. ~5 s on one CPU thread.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

SRC = Path(kb.__file__).resolve().parents[1] / "csrc" / "sigkernel_block.cu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dot(u, v):
    """Channel sum in channel order, ``[P, C] · [P, C] → [P]``."""
    s = u[:, 0] * v[:, 0]
    for c in range(1, u.shape[1]):
        s = s + u[:, c] * v[:, c]
    return s


def wavefront(X: torch.Tensor, h: float, R: int):
    """K [n, n] by the kernel's schedule, vectorised over the pairs a ≤ b
    (each one thread), and the per-pair counts of static nodes formed and
    cells updated (kept or not) and the kept cells' grid coordinates."""
    n, L, C = X.shape
    lmax, L1 = kb.values_bucket(L), L - 1
    scale = torch.sqrt(2.0 / torch.tensor(h, dtype=torch.float32))
    Xs = X * scale
    iu, ju = torch.triu_indices(n, n)
    x = Xs[iu]                                             # [P, L, C]
    y = Xs[ju][:, [min(q, L1) for q in range(lmax)]]       # [P, lmax, C]: padded
    xp = [torch.cat([x[:, p], (-0.5 * _dot(x[:, p], x[:, p]))[:, None]], 1)
          for p in range(L)]                               # [P, C+1] a node
    yp = [torch.cat([y[:, q], (-0.5 * _dot(y[:, q], y[:, q]))[:, None]], 1)
          for q in range(lmax)]
    counts = {"statics": 0, "cells": 0}
    kept = []

    def stat(xv, yv):
        counts["statics"] += 1
        cross = _dot(xv[:, :C], yv[:, :C])
        return torch.exp(cross + (yv[:, C] + xv[:, C]))

    P = iu.shape[0]
    one = torch.ones(P)
    krow = [one] * lmax
    gs = [stat(xp[0], yp[q]) for q in range(lmax)]  # the bottom static row, in place
    for i0 in range(0, L1, R):
        rows = [xp[min(i0 + s + 1, L1)] for s in range(R)]
        keep = [i0 + s < L1 for s in range(R)]
        gr = [[None] * lmax for _ in range(R)]
        kr = [[None] * lmax for _ in range(R)]
        gbot = [None] * lmax  # row 0's reads of gs, each before the top row's write
        gbot[0] = gs[0]
        for s in range(R):
            gr[s][0], kr[s][0] = stat(rows[s], yp[0]), one
        gs[0] = gr[R - 1][0]
        for t in range(lmax + R - 2):
            if t + 1 < lmax:
                gbot[t + 1] = gs[t + 1]
                for s in range(R):
                    assert gr[s][t + 1] is None
                    gr[s][t + 1] = stat(rows[s], yp[t + 1])
                gs[t + 1] = gr[R - 1][t + 1]
            for s in range(R):
                j = t - s
                if not 0 <= j < lmax - 1:
                    continue
                gd, kd = (gbot, krow) if s == 0 else (gr[s - 1], kr[s - 1])
                args = (gr[s][j + 1], gr[s][j], gd[j + 1], gd[j], kr[s][j], kd[j + 1], kd[j])
                assert all(a is not None for a in args), (i0, t, s)
                gu1, gu0, gd1, gd0, kl, kd1, kd0 = args
                z = ((gu1 - gu0) - gd1) + gd0
                A = 1.0 + z * (0.5 + z * kb._I12)
                B = 1.0 - z * z * kb._I12
                kn = (kl + kd1) * A - kd0 * B
                assert kr[s][j + 1] is None
                counts["cells"] += 1
                if s == 0 or keep[s]:
                    kr[s][j + 1] = kn
                    if j < L1:
                        kept.append((i0 + s, j))
                else:
                    kr[s][j + 1] = kd1
        assert all(a is b for a, b in zip(gs, gr[R - 1]))
        krow = kr[R - 1]
    K = torch.empty(n, n)
    K[iu, ju] = krow[L1]
    K[ju, iu] = krow[L1]
    return K, counts, kept


# (L, C): L = 2, 5, 40, 41, 64 and C = 1, 3, 8 inside L·C ≤ 128; the last
# band is partial wherever R does not divide L - 1 (39 and 63 at every R)
SHAPES = [(2, 8), (5, 3), (5, 8), (40, 3), (41, 1), (64, 1)]


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("L,C", SHAPES)
def test_wavefront_gives_the_twins_k_bit_for_bit(L, C, R):
    rng = np.random.default_rng(1000 * L + 10 * C + R)
    n = 3
    X = torch.from_numpy(np.cumsum(rng.uniform(-0.1, 0.1, (n, L, C)), 1).astype(np.float32))
    K, counts, kept = wavefront(X, 4.0, R)
    assert torch.equal(K, kb.block_gram_plain(X, 4.0))
    assert torch.isfinite(K).all()
    # every cell of the grid kept exactly once, in band order
    assert sorted(kept) == [(i, j) for i in range(L - 1) for j in range(L - 1)]
    assert len(set(kept)) == len(kept)
    # what the plan counts (at the kernel's R) is what the schedule forms
    lmax, bands = kb.values_bucket(L), -(-(L - 1) // R)
    assert counts["statics"] == lmax * (1 + bands * R)
    assert counts["cells"] == (lmax - 1) * bands * R
    if R == kb.VALUES_BAND_ROWS[lmax]:
        plan = kb.block_values_plan(n, L, C)
        assert (plan.statics, plan.cells, plan.bands) == (
            counts["statics"], counts["cells"], bands)
        assert plan.padded_rows == bands * R - (L - 1)


def test_the_kernel_sweeps_the_plans_band_rows_and_instantiations():
    src = SRC.read_text()
    lim, below, above = map(int, re.search(
        r"int band_rows\(\) \{ return LMAX <= (\d+) \? (\d+) : (\d+); \}", src).groups())
    assert {b: below if b <= lim else above for b in kb.VALUES_BUCKETS} == kb.VALUES_BAND_ROWS
    cases = re.findall(r"K3_CASE\((\d+), (\d+)\)", src)
    assert sorted((int(b), int(c)) for b, c in cases) == sorted(kb.values_instantiations())
    # each reachable (bucket, C) is instantiated, and nothing unreachable
    reach = {(kb.values_bucket(L), C) for L in range(2, 65) for C in range(1, 9)
             if kb.block_values_supported(2, L, C, 1.0)}
    assert reach == set(kb.values_instantiations())


def test_block_values_envelope():
    assert kb.block_values_supported(1024, 40, 2, 4.0)
    assert kb.block_values_supported(1024, 16, 8, 4.0)
    assert kb.block_values_supported(2, 64, 2, 1.0)        # L·C = 128
    assert kb.block_values_supported(2, 42, 3, 1.0)
    assert not kb.block_values_supported(8, 17, 8, 4.0)    # L·C = 136
    assert not kb.block_values_supported(8, 5, 9, 4.0)     # C = 9
    assert not kb.block_values_supported(8, 65, 1, 4.0)    # L = 65
    assert not kb.block_values_supported(1, 5, 2, 4.0)     # one particle
    assert not kb.block_values_supported(8, 5, 2, None)    # bandwidth
    # K1's envelope is K3's at C = 4..8 (C ≤ 3 it also takes L ≤ 64)
    for C, L in ((4, 32), (5, 25), (6, 21), (7, 18), (8, 16)):
        assert kb.block_supported(8, L, C, 4.0) and kb.block_values_supported(8, L, C, 4.0)
        assert not kb.block_supported(8, L + 1, C, 4.0)
    assert kb.block_supported(8, 64, 3, 4.0) and not kb.block_values_supported(8, 64, 3, 4.0)
