"""Time the port's earlier end-to-end paths in two checkouts on one card.

    python3 chip_ab.py A_DIR B_DIR [--solves N] [--out FILE]

Runs each checkout's own ``chip_smoke.py`` phases in fresh processes, in the
order A, B, B, A, so that a slow or fast spell of the host falls on both:
the calibrated λ=0 solve (``flagship_solve``, with its Gram + adjoint stage
``sig_gram_adjoint``), K1 alone at [1024, 40, 2] through the tree's
``block_gram_and_grad`` on the smoke's seeded paths (``k1_timing``: a
warm-up call, then three times 5 calls by CUDA events), K3 alone at the
same shape through the tree's ``block_gram`` (``k3_timing``: timed alike,
with a SHA-1 of K, which the two trees must share) and ``gram_sym`` at
λ=0 on τ-like knots [1024, 16, 8] (its wall ms, the median of 5 host-timed
calls, and its launches: K3 or the tree's pair list), the pinned λ=3 solves in
fp32 and with the bf16 adjoint (``pinned_solve``, ``bf16_pinned_solve``;
``N`` chained solves each, default 7, after a warm-up), K2 alone at
[1024, 40, 2] through the tree's ``block3_gram_and_grad`` on the smoke's
seeded paths (``k2_timing``: a warm-up call, then three times 5 calls by
CUDA events), K4 alone at the flagship pair list, the upper triangle of
the smoke's seeded [1024, 40, 2] paths at h = 4 (``k4_timing``: the tree's
``fused_forward`` with residuals and values only and its ``fused_backward``
on those residuals, a warm-up call each, then the median of three runs of 5
calls by CUDA events, and a SHA-1 of k's, ck's and rc's bytes, which the two
trees must share), K6 alone on the same residuals (``k6_timing``, timed
alike), the pinned λ=3 solve on linear statics
(``pinned_linear_solve``, ``N`` chained solves) and K5 alone at its
flagship linear list, the upper triangle of that solve's τ (``k5_timing``:
the tree's ``tiled_forward`` with checkpoints and ``tiled_backward``, a
warm-up call each, then the median of three runs of 5 calls by CUDA
events), K8 alone at the planning shape [1048576, 2, 2] λ=6 (``k8_timing``:
the tree's ``mxu_chain_fwd`` and ``mxu_chain_bwd`` on ``knot_increments(1024)``
from seed 8, a warm-up call each, then the median of three runs of 5 and
of 3 calls by CUDA events), the planning
iteration at 1024 particles (5 chained iterations), K7 alone at the
streamed λ=0 Gram's list (every pair of the τ of two flagship rollouts,
1,048,576 pairs) and at the flagship triangle list (``k7_timing``: the
tree's ``small_forward`` values only and with the residual and its
``small_backward``, median of three runs of 5 calls by CUDA events, and a
SHA-1 of each list's k, which the trees should share, reported), the
calibrated kernel's streamed ``gram(X, Y)`` with its gradient
(``lambda0_streamed_gram``: wall ms and peak memory), the reference's
planning run (``PlannerConfig()``, 20 particles × 500 iterations), the
policy-mode solve (``policy_solve``), the streamed λ=3 ``gram(X, Y)`` at
[1024, 40, 2]² with its gradient (``streamed_gram``, its wall ms) and last
K9's ``k9_vs_plain`` (its
rows at [1024, 280], [1024, 840] and [1024, 1400] carry the kernel's and
the library call's times; where the tree has ``phase_k9_timing``, those
times are taken right after the build, in a fresh process). Each phase keeps its own checks (launch counts,
finite outputs, a falling cost). Every phase line goes to ``FILE`` (default
``build/ab_paths.jsonl``); the standard output ends with one JSON
object per run and, last, the metrics of A and B side by side (each the
median over its runs of the per-run medians), K9's times by shape among
them. Needs a CUDA card; exits
non-zero without one or when a phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# metric: (phase, key) of each metric the runs are compared on
METRICS = {
    "flagship_solve": ("flagship_solve", "ms_per_solve_median"),
    "flagship_sig_gram_adjoint": ("flagship_solve", "stages_ms.sig_gram_adjoint"),
    "k1_timing": ("k1_timing", "kernel_ms"),
    "pinned_solve": ("pinned_solve", "ms_per_solve_median"),
    "bf16_pinned_solve": ("bf16_pinned_solve", "ms_per_solve_median"),
    "pinned_linear_solve": ("pinned_linear_solve", "ms_per_solve_median"),
    "planning_iter": ("planning_iter", "ms_per_iter_median"),
    "planning_run": ("planning_run", "wall_s"),
    "policy_solve": ("policy_solve", "ms_per_solve_median"),
    "k2_timing": ("k2_timing", "kernel_ms"),
    "k4_timing_forward": ("k4_timing", "forward_ms"),
    "k4_timing_values_only": ("k4_timing", "values_only_ms"),
    "k4_timing_backward": ("k4_timing", "backward_ms"),
    "k6_timing": ("k6_timing", "k6_ms"),
    "streamed_gram": ("streamed_gram", "wall_ms"),
    "k5_timing_forward": ("k5_timing", "forward_ms"),
    "k5_timing_backward": ("k5_timing", "backward_ms"),
    "k8_timing_forward": ("k8_timing", "forward_ms"),
    "k8_timing_backward": ("k8_timing", "backward_ms"),
    "k7_streamed_values_only": ("k7_timing", "streamed.values_only_ms"),
    "k7_streamed_forward": ("k7_timing", "streamed.forward_ms"),
    "k7_streamed_backward": ("k7_timing", "streamed.backward_ms"),
    "k7_flagship_values_only": ("k7_timing", "flagship.values_only_ms"),
    "k7_flagship_forward": ("k7_timing", "flagship.forward_ms"),
    "k7_flagship_backward": ("k7_timing", "flagship.backward_ms"),
    "lambda0_streamed_gram": ("lambda0_streamed_gram", "wall_ms"),
    "lambda0_streamed_gram_peak_mib": ("lambda0_streamed_gram", "peak_allocated_mib"),
    "k3_timing": ("k3_timing", "kernel_ms"),
    "gram_sym_c8": ("k3_timing", "gram_sym_c8_wall_ms"),
}


def k1_timing(cs) -> None:
    """K1 at [1024, 40, 2] through the tree's public ``block_gram_and_grad``
    on the smoke's seeded smooth paths (``phase_k1``'s): one warm-up call,
    then the median of three runs of 5 calls timed by CUDA events; one JSON
    line."""
    import torch
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    X = cs.smooth_paths(1024, 40, 2, torch.Generator(device="cuda").manual_seed(0))
    kb.block_gram_and_grad(X, 4.0)
    torch.cuda.synchronize()
    samples = [cs.event_ms(lambda: kb.block_gram_and_grad(X, 4.0), 5) for _ in range(3)]
    print(json.dumps({"phase": "k1_timing", "shape": [1024, 40, 2],
                      "kernel_ms": statistics.median(samples),
                      "kernel_ms_samples": samples}), flush=True)


def k3_timing(cs) -> None:
    """K3 at [1024, 40, 2] through the tree's public ``block_gram`` on the
    smoke's seeded smooth paths (``phase_k3``'s first shape, seed 3, h = 4):
    one warm-up call, then the median of three runs of 5 calls timed by CUDA
    events, and a SHA-1 of K's bytes, which the two trees must share. Then
    ``gram_sym`` at λ=0 on τ-like knots [1024, 16, 8] (seed 16, bandwidth
    4; the tree's route: K3 inside the JAX block envelope where the tree
    takes it there, else K7's pair list): a warm-up call, then the median of
    five host-timed calls ending in a synchronise, and the launches of one
    call; one JSON line."""
    import hashlib
    import time

    import torch
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    X = cs.smooth_paths(1024, 40, 2, torch.Generator(device="cuda").manual_seed(3))
    K = kb.block_gram(X, 4.0)
    torch.cuda.synchronize()
    sha = hashlib.sha1(K.cpu().numpy().tobytes()).hexdigest()
    samples = [cs.event_ms(lambda: kb.block_gram(X, 4.0), 5) for _ in range(3)]
    Xk = cs.smooth_paths(1024, 16, 8, torch.Generator(device="cuda").manual_seed(16))
    kern = SignatureKernel(0, 4.0)
    _, launches, _, _ = cs.run_counted(lambda: kern.gram_sym(Xk))
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern.gram_sym(Xk)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"phase": "k3_timing", "shape": [1024, 40, 2], "sha1_k": sha,
                      "kernel_ms": statistics.median(samples), "kernel_ms_samples": samples,
                      "gram_sym_c8_shape": [1024, 16, 8],
                      "gram_sym_c8_wall_ms": statistics.median(walls),
                      "gram_sym_c8_wall_ms_samples": walls,
                      "gram_sym_c8_launches": launches}), flush=True)


def k2_timing(cs) -> None:
    """K2 at [1024, 40, 2] through the tree's public ``block3_gram_and_grad``
    on the smoke's seeded smooth paths: one warm-up call, then the median of
    three runs of 5 calls timed by CUDA events; one JSON line."""
    import torch
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    X = cs.smooth_paths(1024, 40, 2, torch.Generator(device="cuda").manual_seed(3))
    kb3.block3_gram_and_grad(X, 4.0)
    torch.cuda.synchronize()
    samples = [cs.event_ms(lambda: kb3.block3_gram_and_grad(X, 4.0), 5) for _ in range(3)]
    print(json.dumps({"phase": "k2_timing", "shape": [1024, 40, 2],
                      "kernel_ms": statistics.median(samples),
                      "kernel_ms_samples": samples}), flush=True)


def k4_k6_timing(cs) -> None:
    """K4 and K6 at the flagship pair list (``phase_k4``'s: the upper
    triangle of the smoke's smooth [1024, 40, 2] paths from seed 4 at h = 4,
    cotangent 1 on the diagonal and 2 off it) through the tree's
    ``fused_forward`` (with residuals, and values only), ``fused_backward``
    and ``fused_backward_bf16`` on those residuals: a warm-up call each,
    then the median of three runs of 5 calls timed by CUDA events; two JSON
    lines, the first (K4) with a SHA-1 of k's, ck's and rc's bytes."""
    import hashlib

    import torch
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

    gen = torch.Generator(device="cuda").manual_seed(4)
    xt, yt, g = cs.triu_tiles(cs.smooth_paths(1024, 40, 2, gen), 4.0)[:3]
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    kf.fused_forward(xt, yt, residuals=False)
    sha = hashlib.sha1()
    for t in (k, ck, rc):
        sha.update(t.cpu().numpy())
    kf.fused_backward(xt, yt, ck, rc, g)
    torch.cuda.synchronize()
    times = {}
    for which, fn in (("forward", lambda: kf.fused_forward(xt, yt, residuals=True)),
                      ("values_only", lambda: kf.fused_forward(xt, yt, residuals=False)),
                      ("backward", lambda: kf.fused_backward(xt, yt, ck, rc, g))):
        times[which] = [cs.event_ms(fn, 5) for _ in range(3)]
    print(json.dumps({"phase": "k4_timing", "shape": [1024, 40, 2], "pairs": xt.shape[2],
                      "sha1_k_ck_rc": sha.hexdigest(),
                      **{f"{w}_ms": statistics.median(t) for w, t in times.items()},
                      **{f"{w}_ms_samples": t for w, t in times.items()}}), flush=True)
    kf.fused_backward_bf16(xt, yt, ck, rc, g)
    torch.cuda.synchronize()
    times = {"k6": [cs.event_ms(lambda: kf.fused_backward_bf16(xt, yt, ck, rc, g), 5)
                    for _ in range(3)]}
    print(json.dumps({"phase": "k6_timing", "shape": [1024, 40, 2], "pairs": xt.shape[2],
                      **{f"{w}_ms": statistics.median(t) for w, t in times.items()},
                      **{f"{w}_ms_samples": t for w, t in times.items()}}), flush=True)


def k5_timing(cs, tau) -> None:
    """K5 at the flagship linear list (the upper triangle of ``tau``, the
    linear pinned solve's τ [1024, 40, 2], cotangent 1 on the diagonal and 2
    off it) through the tree's ``tiled_forward`` (with checkpoints) and
    ``tiled_backward``: a warm-up call each, then the median of three runs
    of 5 calls timed by CUDA events; one JSON line."""
    import torch
    from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

    n = tau.shape[0]
    iu, ju = torch.triu_indices(n, n, device="cuda")
    z = kt.pair_increments(tau, tau, iu, ju, None).contiguous()
    g = torch.where(iu == ju, 1.0, 2.0)
    del iu, ju
    _, ck = kt.tiled_forward(z, with_ck=True)
    kt.tiled_backward(z, ck, g)
    torch.cuda.synchronize()
    times = {}
    for which, fn in (("forward", lambda: kt.tiled_forward(z, with_ck=True)),
                      ("backward", lambda: kt.tiled_backward(z, ck, g))):
        times[which] = [cs.event_ms(fn, 5) for _ in range(3)]
    print(json.dumps({"phase": "k5_timing", "shape": [n, 40, 2], "pairs": z.shape[-1],
                      **{f"{w}_ms": statistics.median(t) for w, t in times.items()},
                      **{f"{w}_ms_samples": t for w, t in times.items()}}), flush=True)


def k8_timing(cs) -> None:
    """K8 alone at the planning shape [1048576, 2, 2] λ=6 (the increments of
    1024 knot paths, ``knot_increments(1024)`` from seed 8, cotangent from
    the same generator) through the tree's public ``mxu_chain_fwd`` and
    ``mxu_chain_bwd``: a warm-up call each, then the median of three runs of
    5 (forward) and 3 (backward) calls timed by CUDA events; one JSON line."""
    import torch
    from sigsvgd_tpu_torch.kernels import mxu_chain as mc

    gen = torch.Generator(device="cuda").manual_seed(8)
    inc = cs.knot_increments(1024, gen)
    B = inc.shape[0]
    g = torch.randn(B, generator=gen, device="cuda")
    z = (inc / float(4 ** 6)).reshape(B, 4).contiguous()
    del inc
    geom = (2, 2, 1, 2)
    mc.mxu_chain_fwd(z, *geom)
    mc.mxu_chain_bwd(z, g, *geom)
    torch.cuda.synchronize()
    times = {"forward": [cs.event_ms(lambda: mc.mxu_chain_fwd(z, *geom), 5) for _ in range(3)],
             "backward": [cs.event_ms(lambda: mc.mxu_chain_bwd(z, g, *geom), 3)
                          for _ in range(3)]}
    print(json.dumps({"phase": "k8_timing", "shape": [B, 2, 2], "dyadic_order": 6,
                      **{f"{w}_ms": statistics.median(t) for w, t in times.items()},
                      **{f"{w}_ms_samples": t for w, t in times.items()}}), flush=True)


def k7_timing(cs, kern, taus) -> None:
    """K7 alone at two pair lists through the tree's ``small_forward``
    (values only, and with the residual) and ``small_backward`` on that
    residual: the streamed λ=0 Gram's list (every pair of ``taus``, the τ of
    two flagship rollouts, 1,048,576 pairs, at the calibrated kernel's
    bandwidth; cotangent 1) and the flagship triangle list (``phase_k7``'s:
    the upper triangle of the smoke's smooth [1024, 40, 2] paths from seed
    8 at h = 4). A warm-up call each, then the median of three runs of 5
    calls timed by CUDA events, and a SHA-1 of each list's values-only k,
    which the two trees should share; one JSON line."""
    import hashlib

    import torch
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    X, Y = taus
    n, m = X.shape[0], Y.shape[0]
    idx = torch.arange(n * m, device="cuda")
    lists = {"streamed": (*cs.pair_tiles(X, Y, idx // m, idx % m, kern.bandwidth),
                          torch.ones(n * m, device="cuda"))}
    del idx
    gen = torch.Generator(device="cuda").manual_seed(8)
    lists["flagship"] = cs.triu_tiles(cs.smooth_paths(1024, 40, 2, gen), 4.0)[:3]
    row = {"phase": "k7_timing", "sha1_k": {}}
    for name, (xt, yt, g) in lists.items():
        (k,) = ks.small_forward(xt, yt, residuals=False)
        _, fac = ks.small_forward(xt, yt, residuals=True)
        ks.small_backward(xt, yt, fac, g)
        torch.cuda.synchronize()
        row["sha1_k"][name] = hashlib.sha1(k.cpu().numpy().tobytes()).hexdigest()
        times = {}
        for which, fn in (("values_only", lambda: ks.small_forward(xt, yt, residuals=False)),
                          ("forward", lambda: ks.small_forward(xt, yt, residuals=True)),
                          ("backward", lambda: ks.small_backward(xt, yt, fac, g))):
            times[which] = [cs.event_ms(fn, 5) for _ in range(3)]
        row[name] = {"pairs": xt.shape[2],
                     **{f"{w}_ms": statistics.median(t) for w, t in times.items()},
                     **{f"{w}_ms_samples": t for w, t in times.items()}}
        del k, fac
    del lists
    print(json.dumps(row), flush=True)


K9_SHAPES = ((1024, 280), (1024, 840), (1024, 1400))


def child(root: Path, n_solves: int) -> int:
    """One run in this process: ``root``'s package and smoke phases."""
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(root))
    os.chdir(root)
    import chip_smoke as cs
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)

    if Path(cs.__file__).resolve().parent != root:
        raise AssertionError(f"imported {cs.__file__}, not {root}'s smoke")
    cs.N_SOLVES = n_solves
    cs.phase_build()
    # K9 timed in a fresh process before the paths, where the tree has it
    timing = cs.phase_k9_timing() if hasattr(cs, "phase_k9_timing") else None
    _, kern0, taus = cs.phase_flagship()
    k1_timing(cs)
    k3_timing(cs)
    k7_timing(cs, kern0, taus)
    cs.phase_lambda0_streamed_gram(kern0, *taus)
    del kern0, taus
    cs.phase_pinned()
    k2_timing(cs)
    k4_k6_timing(cs)
    _, tau = cs.phase_pinned_linear()
    k5_timing(cs, tau)
    del tau
    k8_timing(cs)
    cs.phase_planning_iter()
    cs.phase_planning_run()
    cs.phase_policy()
    cs.phase_streamed_gram()
    # last: the parent's profiler sessions slow later host dispatch
    if timing is None:
        cs.phase_k9()
    else:
        cs.phase_k9(timing)
    return 0


def run(root: Path, label: str, n_solves: int, out) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--child", str(root),
                           "--solves", str(n_solves)],
                          capture_output=True, text=True, timeout=1500)
    rows, k9 = {}, {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            out.write(json.dumps({"run": label, **row}) + "\n")
            rows.setdefault(row.get("phase"), row)  # a phase's first row holds its metric
            # k9_timing and k9_vs_plain have a row a shape: pick the timed ones by shape
            if row.get("phase") in ("k9_timing", "k9_vs_plain") and "kernel_ms" in row:
                k9[tuple(row["shape"])] = row
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"chip_ab: the run of {root} failed (exit {proc.returncode})")
    got = {"run": label, "root": str(root)}
    for metric, (phase, key) in METRICS.items():
        value = rows[phase]
        for part in key.split("."):
            value = value[part]
        got[metric] = value
        for samples in (key.replace("_median", "_samples"), f"{key}_samples"):
            if samples != key and samples in rows[phase]:
                got[metric + "_samples"] = rows[phase][samples]
    for n, d in K9_SHAPES:
        got[f"k9_{n}x{d}"] = {k: k9[(n, d)][k] for k in ("kernel_ms", "library_ms")}
    got["k4_sha1"] = rows["k4_timing"]["sha1_k_ck_rc"]
    got["k3_sha1"] = rows["k3_timing"]["sha1_k"]
    got["gram_sym_c8_launches"] = rows["k3_timing"]["gram_sym_c8_launches"]
    got["k7_sha1"] = rows["k7_timing"]["sha1_k"]
    print(json.dumps(got), flush=True)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--child", type=Path)
    ap.add_argument("--solves", type=int, default=7)
    ap.add_argument("--out", type=Path, default=Path("build/ab_paths.jsonl"))
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child.resolve(), args.solves)
    if len(args.roots) != 2:
        ap.error("give two checkouts, A and B")
    a, b = (r.resolve() for r in args.roots)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    runs = {"A": [], "B": []}
    with args.out.open("w") as out:
        for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
            runs[label].append(run(root, label, args.solves, out))
    compare = {metric: {label: statistics.median(r[metric] for r in rs)
                        for label, rs in runs.items()} for metric in METRICS}
    for n, d in K9_SHAPES:
        key = f"k9_{n}x{d}"
        compare[key] = {f"{label}_{k}": statistics.median(r[key][k] for r in rs)
                        for label, rs in runs.items() for k in ("kernel_ms", "library_ms")}
    sums = {r["k4_sha1"] for rs in runs.values() for r in rs}
    k3_sums = {r["k3_sha1"] for rs in runs.values() for r in rs}
    k7_sums = {label: sorted({json.dumps(r["k7_sha1"], sort_keys=True) for r in rs})
               for label, rs in runs.items()}
    print(json.dumps({"compare": compare, "A": str(a), "B": str(b),
                      "k4_sha1_agree": len(sums) == 1,
                      "k3_sha1_agree": len(k3_sums) == 1,
                      "gram_sym_c8_launches": {label: rs[0]["gram_sym_c8_launches"]
                                               for label, rs in runs.items()},
                      "k7_sha1": k7_sums,
                      "k7_sha1_agree": len({s for v in k7_sums.values() for s in v}) == 1}),
          flush=True)
    if len(sums) != 1:
        raise SystemExit(f"chip_ab: the trees' K4 forwards disagree: {sorted(sums)}")
    if len(k3_sums) != 1:
        raise SystemExit(f"chip_ab: the trees' K3 values disagree: {sorted(k3_sums)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
