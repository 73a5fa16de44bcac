"""The numerical gate of K4's fp32 backward, on the CPU: its lane schedule's
arithmetic against the exact adjoint at the card's shapes.

    python3 tools/k4_carry_gate.py [--pairs N]

K4's backward rebuilds each band's primal toward -j from the band's top row,
which it carries from the band above's rebuild and re-anchors only at the
checkpoint bands and at every row's right edge (as the JAX kernel's
``_bwd_rows_fast``). This runs the CPU model of that schedule
(``tests/test_torch_fused_schedule.py::backward_model``, the kernel's
roundings pinned as its intrinsics pin them) at the shapes of
``chip_smoke.py``'s ``k4_vs_plain`` (a few hundred pairs of each list, from
numpy-seeded smooth paths at h = 4) and of the card test
``test_k4_matches_plain_twin_on_the_card`` ((40, 40) and (23, 9) at C = 1..8,
paths × 0.5), and prints the tile gradients' and the per-path sums' errors,
scaled by their max, against the twin in fp64 beside K4's tolerance
(``chip_smoke.K4_TOL``: 4e-4, which the card holds K4 to), and against the
fp32 twin (whose own wavefront rounding is reported beside it). One JSON
line a shape; exits 1 if an error against fp64 exceeds the tolerance.
Needs no card and imports nothing of JAX; ~5 min on one thread.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf  # noqa: E402
from test_torch_fused_schedule import backward_model  # noqa: E402

TOL = 4e-4


def smooth(rng, n, L, C):
    return np.cumsum((rng.random((n, L, C)) - 0.5) * 0.2, 1)


def tiles(X, Y, ix, iy, scale):
    def t(A, i):
        return torch.from_numpy((A * scale)[i].transpose(1, 2, 0).astype(np.float32)).contiguous()
    return t(X, ix), t(Y, iy)


def err(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def per_path(d, idx, n):
    out = torch.zeros(n, d.shape[0], d.shape[1], dtype=torch.float64)
    return out.index_add_(0, idx, d.double().permute(2, 0, 1))


def gate(name, xt, yt, gout, paths=None) -> bool:
    t0 = time.perf_counter()
    _, ck, rc = kf.fused_forward_plain(xt, yt, residuals=True)
    _, dx, dy = backward_model(xt, yt, ck, rc, gout)
    dx32, dy32 = kf.fused_backward_plain(xt, yt, gout)
    _, dx64, dy64 = kf.fused_pairs_plain(xt.double(), yt.double(), gout.double())
    row = {"case": name, "pairs": xt.shape[2], "Lx": xt.shape[0], "Ly": yt.shape[0],
           "C": xt.shape[1], "dx_vs_fp64": err(dx, dx64), "dy_vs_fp64": err(dy, dy64),
           "dx_vs_fp32": err(dx, dx32), "dy_vs_fp32": err(dy, dy32),
           "twin_fp32_dx_vs_fp64": err(dx32, dx64), "twin_fp32_dy_vs_fp64": err(dy32, dy64)}
    if paths is not None:
        ix, iy, nx, ny = paths
        row["dX_vs_fp64"] = err(per_path(dx, ix, nx), per_path(dx64, ix, nx))
        row["dY_vs_fp64"] = err(per_path(dy, iy, ny), per_path(dy64, iy, ny))
    row["tol"] = TOL
    row["ok"] = all(v <= TOL for k, v in row.items() if k.endswith("_vs_fp64")
                    and not k.startswith("twin"))
    row["s"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    return row["ok"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=300)
    args = ap.parse_args()
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    h = 4.0
    ok = True
    n = int((np.sqrt(8 * args.pairs + 1) - 1) / 2)   # n(n+1)/2 ≈ pairs
    for name, L, C in (("flagship_triu", 40, 2), ("triu_x49x3", 49, 3), ("triu_x17x7", 17, 7)):
        X = smooth(rng, n, L, C)
        iu, ju = np.triu_indices(n)
        xt, yt = tiles(X, X, iu, ju, h ** -0.5)
        g = torch.from_numpy(np.where(iu == ju, 1.0, 2.0).astype(np.float32))
        ok &= gate(name, xt, yt, g, (torch.from_numpy(iu), torch.from_numpy(ju), n, n))
    Xa, Ya = smooth(rng, 77, 40, 2), smooth(rng, 64, 33, 2)
    ia, ja = rng.integers(0, 77, args.pairs), rng.integers(0, 64, args.pairs)
    xt, yt = tiles(Xa, Ya, ia, ja, h ** -0.5)
    g = torch.from_numpy(rng.standard_normal(args.pairs).astype(np.float32))
    ok &= gate("random_77x40_64x33", xt, yt, g,
               (torch.from_numpy(ia), torch.from_numpy(ja), 77, 64))
    for Lx, Ly in ((40, 40), (23, 9)):
        for C in range(1, 9):
            X, Y = smooth(rng, 64, Lx, C), smooth(rng, 64, Ly, C)
            ix, iy = rng.integers(0, 64, args.pairs), rng.integers(0, 64, args.pairs)
            xt, yt = tiles(X, Y, ix, iy, 0.5)
            g = torch.from_numpy(rng.standard_normal(args.pairs).astype(np.float32))
            ok &= gate(f"card_{Lx}x{Ly}_C{C}", xt, yt, g)
    print(json.dumps({"all_within_tol": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
