"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from ``sigsvgd_tpu_torch/csrc`` with nvcc for sm_90a, one
   process per source, with the registers, spills and stack frame of each
   function of each source from ptxas (its report kept beside the library,
   so a cached library reports too); a K1 or K2 instantiation (span
   templates 3 and 5 × C = 1..3, template 3 × C = 4..8), a K5 or K8
   function, or an instantiation of K3 (length bucket × C inside L·C ≤
   128), K4 (span template × C = 1..8), K6 (× C = 1..4) or K7 (span 3 × C =
   1..8, span 5 × C = 1..4; the forward values only and with the residual),
   that spills or
   is missing from the report, or a K1, K8, K3, K4, K6 or K7 function with a
   stack frame, fails the smoke;
2. K1 (the λ=0 signature-kernel Gram + adjoint; a lane group per pair)
   against its plain PyTorch twin on the card, at the flagship shape
   [1024, 40, 2], a ragged [333, 40, 2], [40, 64, 3] (16 lanes a pair) and
   ``WIDE_SHAPES`` (C = 4..8: the planner's knots [1024, 3, 7] at h = 1.5,
   [1024, 16, 8], [1024, 32, 4] and a ragged [333, 18, 7]): K bit for bit,
   dX scaled by max|dX| to atol 5e-5; also K and dX of both against the
   twin in fp64, the device memory each instantiation's first launch takes,
   the plan (lanes, spans, bands, tiles, resident blocks, shared memory,
   scratch, traffic), and at n = 1024 K and dX bit for bit across two
   calls and the times of K1 and its twin with the bound;
3. the flagship DuSt solve (7-DoF Panda, bookshelf_small, 1024 policies,
   H=40, 2 Adam SVGD steps, calibrated order 0) for a few chained MPC
   solves, with K1's launch count read around them, then the two stages of
   the solve timed apart (rollout + cost gradient; Gram + adjoint) and one
   more solve traced with ``torch.profiler``; then τ of two rollouts of
   fresh policy draws for phases 6 and 7; then bench's MC workload
   (``mc_solve``: the same calibrated controller with 10 action samples,
   drawn from a seeded CUDA generator; 3 chained solves after a warm-up,
   K1 launched twice a solve, costs [2, 10, 1024], the sampled rollout and
   cost and the τ pull-back with ``gram_and_grad`` timed apart, one solve
   traced) and ``mc_small_vs_cpu`` (the MC solve at 64 policies, H = 40,
   10 samples on the card and on the CPU with the same given draws: the
   first step's costs, K and the repulsion, the weights' argmax and the
   new policies, as ``phase_mc_small_vs_cpu`` says);
4. K3 (the λ=0 values-only block Gram, one thread a pair swept in bands
   as a wavefront) against its twin and against K1's K (both bit for bit)
   at [1024, 40, 2], [333, 40, 2], [40, 64, 2] (L·C = 128, the 64-node
   bucket) and at C = 8 ([1024, 16, 8] and [300, 16, 8]), with its time
   beside K1's at n = 1024, its plan, its registers and the issue floor
   its SASS implies;
5. K7 (the λ=0 pair-list forward, values only and with its residual, and
   its backward; a lane group per pair) against its twin at the flagship
   upper-triangle list of [1024, 40, 2] (524,800 pairs: the first and the
   last 16,384 held, the last in the later passes of the three launches'
   persistent loops, asserted),
   [77, 40, 2] × [64, 33, 2] random pairs, [40, 64, 3] (ly1 = 63),
   [64, 41, 4] (L·C > 128) and [256, 20, 8]: k and fac to atol 3e-5, dX and
   dY (summed per path) scaled to atol 5e-5 against the fp32 twin, each
   also against the twin in fp64 (reported); each launch's plan
   (``small_plan``: lanes, spans, runs, tiles, resident blocks, stages,
   traffic, sector share); times, bounds, the twin's times and the
   residual's memory;
6. ``lambda0_streamed_gram``: the calibrated flagship kernel's
   ``gram(X, Y)`` on the two τ batches ([1024, 40, 2] × [1024, 40, 2],
   1,048,576 pairs) with its gradient: wall time, peak memory, exactly 2 K7
   forward and 1 K7 backward launches and no other kernel, rows 0..63 and
   960..1023 held against the twin; K7's launches timed at that list;
7. ``gram_sym`` of that kernel on τ [1024, 40, 2]: exactly 1 K3 launch and
   no other kernel, K equal to K1's bit for bit; and at τ-like knots
   [1024, 16, 8] (C = 8, inside the JAX package's block envelope): 1 K3
   launch, no K7, K the twin's bit for bit;
8. ``gram_and_grad`` at bench's planning knots [1024, 3, 7] (h = 1.5): at
   λ=0 one K1 launch, at λ=3 one K2 launch, nothing else, with the parent's
   route (the pair list: K7's forward and backward at λ=0, K4's at λ=3) run
   and timed beside it in turns; and beyond the block envelope (L·C >
   128): at λ=0 [64, 41, 4] one K7 forward and backward, at λ=3
   [64, 33, 4] one K4 forward and backward; each against the same route on
   the CPU (the twins);
9. K2 (the λ=3 Gram + adjoint) against its twin at [128, 40, 2], a ragged
   [77, 40, 2], [40, 49, 3], the flagship [1024, 40, 2], where each of
   K2's persistent blocks takes several tiles, and ``WIDE_SHAPES`` (C =
   4..8, bit for bit across two calls at n = 1024): K against the twin to atol
   1e-4 (the values-only twin at the flagship shape), dX scaled against the
   twin in fp64 to atol 4e-4 (the fp32 twin's own dX is as far from it);
   at the flagship shape K and dX bit for bit across two calls and the
   plan (lanes a pair, spans, blocks, scratch, traffic); the first launch's
   device memory outside the caching allocator, and the times of K2 and of
   its twin at [1024, 40, 2] (the twin by chunks of pairs) and at
   [128, 40, 2];
10. the pinned order-3 solve (bench.py's ``ctrl_sig_pinned``: calibration
   off), as phase 3, with K2's launch count;
11. the policy-mode solve (bench.py's ``ctrl_rbf`` with
   ``fused_velocity=True``), as phase 3, with K9's launch count; then, as
   phase 3 with no hand kernel launched (every wrapper's count read and
   held at 0): ``trajectory_solve`` (``kernel_mode="trajectory"`` with
   DuSt's default ``GaussianKernel``; the kernel terms timed apart),
   ``scaled_solve`` and ``matrix_solve`` (policy mode, ``stein_sampler``
   "ScaledSVGD" and "MatrixSVGD" with a ``ScaledGaussianKernel``, a
   280 × 280 metric; one velocity timed apart) and ``default_sig_solve``
   (the JAX ``DuSt``'s default ``SignatureKernel(dyadic_order=2)``,
   uncalibrated: the wavefront's pair list, ``DEFAULT_SIG_SOLVES`` solves;
   then one ``gram_and_grad`` with its chunk count and peak memory, and K
   of 64 pairs against the fp64 CPU scan of the same increments);
12. K8 (the order ≥ 6 hop chain on tensor cores, forward and backward)
   against its bf16 twin and against the fp32 block propagator at the
   planning shape [1048576, 2, 2] λ=6 (the increments of 1024 knot paths
   at h = 1.5), a ragged [389, 4, 4] λ=6 (16 hops) and [1000, 2, 2] λ=7:
   K and dz scaled by their max, atol 1e-3 / 2e-3 against the twin and
   5e-3 / 1e-2 against the fp32 route; each shape's launch plan
   (``chain_plan``: warpgroups, ring stages, shared memory, scratch, the
   basis bytes read through L2); at the planning shape k and dz bit for
   bit across two calls, the times of both kernels, of the twin and of the
   fp32 route, and the first launch's memory;
13. ``planning_iter``: bench's planning shape (1024 knot particles, depth 6,
   ``mxu_precision="default"``, T=200, ``bookshelf_small``), 3 warm-up and
   5 timed chained SVGD iterations with K8's counters read around them
   (one forward and one backward launch per iteration), the stage split and
   one traced iteration; then ``planning_iter_depth3`` and
   ``planning_iter_depth0``, the same at depth 3 (one K2 launch an
   iteration) and 0 (one K1), no other kernel; each with the mean cost
   falling from the first knots to the last;
14. ``planning_run``: ``run_optimisation`` at ``PlannerConfig()``'s width
   (20 particles, depth 6) for ``PLANNING_RUN_ITERS`` = 50 of its 500
   iterations (the planning process's ``robot_planning_full`` runs all 500)
   and ``evaluate_trajectory``: wall time, the mean cost at the first and
   last iteration (it must fall), the success rate and K8's launches (one
   each an iteration);
15. K4 (the λ=3 pair-list forward and fp32 backward, each a lane group per
   pair) against its twin at the flagship upper-triangle pair list of
   [1024, 40, 2] (524,800 pairs: the first and the last 16,384 held, the
   last solved by the later passes of both kernels' persistent loops,
   asserted, all of them timed), [77, 40, 2] ×
   [64, 33, 2] random pairs, [40, 49, 3] (ly1 = 48) and [64, 17, 7]: K to atol 1e-4,
   dX and dY (the pairs' gradients summed per path) scaled against the
   twin in fp64 to atol 4e-4; both kernels' plans (``fused_plan``: lanes,
   spans, runs, tiles, blocks, shared memory, traffic, sector share);
   times, bound, the twin's times and the residuals' memory;
16. K6 (the bf16 delta-form backward, a lane group per pair couple) against
   its bf16 twin at [128, 40, 2], [77, 41, 4] and the flagship pair list,
   where each persistent block takes several tiles of pair couples (rel ≤
   2e-2, cos ≥ 0.999), with its plan, and against K4's
   backward on the same residuals (rel < 0.25, cos > 0.98); its time
   against K4's backward at the flagship pair list;
17. the pinned solve with ``grad_precision="bf16"``, as phase 10, right after
   it: K4's forward and K6 launch twice a solve, K2 and K4's backward never;
18. ``streamed_gram``: ``SignatureKernel(3, 4.0).gram(X, Y)`` at [1024, 40,
   2] × [1024, 40, 2] (1,048,576 pairs) and its gradient with respect to X:
   time, launches, peak memory, rows 0..63 and 960..1023 held against the
   twin;
19. ``pinned_linear_solve``: the pinned order-3 solve on linear statics
   (``build_arm_mpc(calibrate=False, static="linear")``), as phase 10: K5's
   forward and backward once a ``gram_and_grad`` (the list is one chunk,
   asserted), K2, K4 and K6 never; then one ``gram_and_grad``
   with its peak memory;
20. K5 (the λ=3 solve on given increments, forward values only and with its
   checkpoints, and the stable backward; a lane group per pair) against its
   twin at the flagship linear list (the upper triangle of that solve's τ
   [1024, 40, 2], 524,800 pairs, 8 lanes a pair: the first and the last
   16,384 held, the last in the backward's later waves of blocks,
   asserted), [2561, 3, 3] (1 lane), [3, 40, 40] at scale 0.05, a ly1 = 48
   list (16 lanes), a rectangular [39, 17] one (4 lanes), [7, 9] (2
   lanes) and two lists of one band (lx1 = 1 at 1 and 16 lanes): k and
   the checkpoints (in the twin's layout) to rtol 2e-5 / atol 1e-6, dz
   scaled to atol 5e-4 (1e-4 and 1e-3 at [3, 40, 40]); each also against
   the twin in fp64, reported; at the flagship list the plan (lanes,
   spans, tiles, resident blocks, shared memory, checkpoint memory,
   traffic), every K5 function's registers and spills, times, bounds and
   the twin's times;
21. ``dense_lambda3_gram``: ``SignatureKernel(3, 4.0).gram(X, Y)`` at
   [128, 40, 2]² with its gradient, RBF and linear statics: one K5 forward
   and one backward, no K4; held against the same route with the twins in
   K5's place and, at [24, 40, 2] × [17, 33, 2], against the CPU; for the
   record the RBF Gram's pairs through the fused route (K4), timed beside it;
22. ``c12_pair_list``: λ=3 ``gram_and_grad`` at [256, 17, 12] (32,896
   pairs): one K5 forward and one backward, held against the twins' route;
23. ``linear_streamed_gram``: the linear ``gram(X, Y)`` on the two τ batches
   of phase 3 (1,048,576 pairs) with its gradient: two K5 forwards and one
   backward per chunk, wall time, peak memory, rows 0..15 and 1008..1023
   held against the twins;
24. small solves on the card held against the same solves on the CPU, where
   the twins replace the kernels: λ=0, λ=3, λ=3 with the bf16 adjoint, λ=3
   on linear statics (K5), policy mode; λ=0 Grams with their gradient (the
   dense ``gram``, ``gram_sym`` through K3 and through K7);
   ``trajectory_small_vs_cpu`` (16 policies, H = 8: the trajectory mode,
   with and without 4 given action samples, and the ScaledSVGD and
   MatrixSVGD samplers: costs, the trajectory K and its gradient, φ, the
   weights' argmax); ``wavefront_small_vs_cpu`` (λ=2 and λ=0-linear
   ``gram_and_grad``, a λ=1 dense ``gram`` with its gradient: K and the
   gradient, no hand kernel); and 3 planning iterations at batch 8, T=50 in
   fp32 ("highest") and through K8 ("default", the bf16 twin on the CPU);
25. K9 (the fused RBF Stein velocity, 3xTF32 on the tensor cores) against
   its twin (rtol 2e-4, atol 5e-5) at [1024, 280], a ragged [333, 280],
   [1024, 840] and [1024, 1400], the three [1024, D] again with scores 100
   times larger, [1, 1], [1, 280], [77, 1025], [12000, 7] (19 row chunks of
   K, asserted) and [300, 37] under a 64 KiB chunk cap (column chunks); φ
   bit for bit across two calls at each; at each [1024, D] two bounds
   (3xTF32 tensor cores, the contract's; fp32 CUDA cores) and the times
   that ``k9_timing`` took right after the build, in a fresh process
   (``chip_smoke.py --k9-timing``; a profiler session slows the host
   dispatch of the rest of its process): K9 and the library call (the
   twin: cuBLAS fp32) in turns, library, kernel, kernel, library, twice,
   each turn 200 calls; then each replayed from a CUDA graph, without the
   host's dispatch.

Right after the build and ``k9_timing``, a fresh process (``chip_smoke.py
--maze``; these paths are host-bound and a profiler session slows its
process's dispatch) runs the particle maze's and the pendulum's phases:
``k2_maze_shape`` (K2 at the maze's [35, 30, 2] and [36, 30, 2] on its own
τ at h = √32 against the fp32 twin at ``K2_TOL``, with times, plan and
bound), ``pendulum_dust`` and ``pendulum_disco`` (50-step swing-ups through
``experiments/pendulum.py``, DISCO at its full width, no hand kernel),
``maze_small_vs_cpu`` (a 3-step episode, MPF on, RBF and signature kernels,
on the card and the CPU from the same draws, within ``MAZE_TOL``) and
``maze_episode`` (``run_episode`` at ``MazeConfig()``'s width with the
signature kernel and the MPF for up to ``MAZE_STEPS`` steps: ms a control
step, exactly 2 K2 launches a step and no other kernel, a solve and an MPF
update timed apart and traced, the mass posterior), then ``maze_process``
with the process's wall time.

Then a fresh process (``chip_smoke.py --planning``) runs the arm-planning
sweep and the obstacle field: ``k4_sweep_shape``, ``k2_field_shape`` and
``k8_sweep_shape`` (K4 at the quick sweep's knots [8, 3, 7] at depth 3, K2
at the field's knots [16, 4, 2] at h = 3.0, K8 at the full cell's knots
[20, 3, 7] at depth 6, each against its twin at its ``K*_TOL``, with times
and bounds; K4 called directly: the sweep runs K2), ``robot_planning_quick``
(the README's ``--quick`` sweep of ``pillars_4`` through
``run_experiment``: its six rows, each cell's K2 launches, 1 an iteration
in the pathsig cells and none elsewhere),
``robot_planning_full`` (one learned cell at ``PlannerConfig()``: both
trainings at the JAX package's sizes with their epoch losses, the models'
accuracy and AUC, the run's wall time, cost, audit and 500 + 500 K8
launches, ms an iteration), ``obstacle_field`` (300 pathsig iterations, 300
K2, the best cost under 1.5 times the straight line's) and
``planning_small_vs_cpu`` (requests, a sweep cell, the field and the IK on
the card and the CPU within ``PLANNING_SWEEP_TOL``), then
``planning_process`` with its wall time.

Then a fresh process (``chip_smoke.py --lbfgs-mesh``) runs L-BFGS, the
checkpointed runs and the mesh scene: ``planning_lbfgs``
(``run_optimisation`` with ``PlannerConfig(method="pathsig",
optimizer="lbfgs")`` at full width on ``pillars_4``'s first request for
``LBFGS_ITERS`` of its 500 iterations: ms an iteration and line-search
probes an iteration from the cost's calls, the mean cost falling, exactly
one K8 forward and backward an iteration), ``planning_lbfgs_resume`` (the
same config for 20 iterations twice uninterrupted, once interrupted right
after its first checkpoint, once resumed, once on the finished directory:
the two uninterrupted runs and the resumed one bit-equal),
``maze_resume`` (``MazeConfig()``'s width, signature kernel and MPF: 6
steps against 4 with checkpoints every 2 and a resume, bit-equal, 2 K2 a
step), ``dust_lbfgs`` (the pendulum's DuSt with ``lbfgs(memory_size=4)``
and ``roll_opt_state``: 20 steps, zero rolled tails, 3 steps on the card
against the CPU within ``DUST_LBFGS_TOL``) and ``mesh_scene`` (a box STL
in ``pillars_4`` at resolution 48: the native build and the host's grid
build timed, ``grid_sdf`` on the card against the CPU within ``MESH_TOL``
at ``MESH_POINTS`` points, a ``MESH_RUN_ITERS``-iteration pathsig run with
K8 once forward and backward an iteration, the mesh audit of the best
particle timed), then ``lbfgs_mesh_process`` with its wall time. Before
the kernel table a ``smoke_total`` line gives the smoke's wall time.

Then the kernel table line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_SOLVES = 3
DEFAULT_SIG_SOLVES = 3  # the order-2 wavefront solve takes seconds; may be cut
OPT_STEPS = 2
MC_SAMPLES = 10  # bench.py's MC workload: n_action_samples=10
K2_TOL = (1e-4, 4e-4)   # K atol, dX scaled atol (tests/test_pallas_block3.py)
K9_TOL = (2e-4, 5e-5)   # rtol, atol (tests/test_pallas_svgd.py)
K8_TOL = (1e-3, 2e-3)   # K, dz scaled atol against the twin
K8_FP32_TOL = (5e-3, 1e-2)  # against the fp32 route (tests/test_pallas_mxu_chain.py)
K4_TOL = K2_TOL         # K atol, tiles' gradients scaled atol against the fp64 twin
K6_TOL = (2e-2, 0.999)  # rel, cos against the bf16 twin
K6_FP32_TOL = (0.25, 0.98)  # rel, cos against K4's backward (test_bf16_delta_adjoint_matches_fp32)
K7_TOL = (3e-5, 5e-5)   # k and fac atol, per-path gradients scaled atol (tests/test_pallas_small.py)
K7_VALUE_TOL = (3e-5, 2e-5)  # rtol, atol of K7's values against JAX's (tests/test_pallas_small.py)
K5_TOL = (2e-5, 5e-4)   # k rtol (atol 1e-6), dz scaled atol (tests/test_pallas_sigkernel.py)
BF16_SOLVE_TOL = (1e-4, 1e-2)  # K atol, grad_k scaled (tests/test_torch_dust.py, lambda3_bf16)
PLAN_TOL = (1e-4, 1e-5)  # rtol, atol of chained planning runs (tests/test_planning.py)
PEAK_FP32_FLOPS = 67e12  # H100 SXM, CUDA cores (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_BF16_SIMT_FLOPS = 134e12  # H100 SXM, bf16 on the CUDA cores (Hopper white paper)
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's row gains ``process_s``, the seconds since
    the process that emitted it started (a child's rows keep their own)."""
    if "phase" in obj and "process_s" not in obj:
        obj = {**obj, "process_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def all_counters() -> dict:
    """Every hand kernel wrapper's launch counter, by name."""
    from sigsvgd_tpu_torch.kernels import mxu_chain as mc
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks
    from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt
    from sigsvgd_tpu_torch.kernels import svgd_velocity as kv

    fns = (kb.block_gram_and_grad, kb.block_gram, kb3.block3_gram_and_grad,
           kf.fused_forward, kf.fused_backward, kf.fused_backward_bf16, ks.small_forward,
           ks.small_backward, kt.tiled_forward, kt.tiled_backward, mc.mxu_chain_fwd,
           mc.mxu_chain_bwd, kv.fused_rbf_velocity)
    return {f.__name__: f for f in fns}


class Launches:
    """Every hand kernel's launches inside a ``with`` block, in
    ``self.counts``: the counters are set to 0 on entry and read on exit
    (with ``zero=False``, inside another such block, the counts are the
    counters' growth)."""

    def __init__(self, zero: bool = True):
        self.zero = zero

    def __enter__(self):
        self.fns = all_counters()
        if self.zero:
            for f in self.fns.values():
                f.launches = 0
        self.start = {name: f.launches for name, f in self.fns.items()}
        return self

    def __exit__(self, *exc):
        self.counts = {name: f.launches - self.start[name] for name, f in self.fns.items()}

    def expect(self, phase: str, **want):
        """Fail unless the named kernels launched ``want`` times and no
        other kernel launched."""
        full = {name: want.get(name, 0) for name in self.counts}
        if self.counts != full:
            raise AssertionError(f"{phase}: launches {self.counts}, expected {full}")


def host_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the fp32
    operations over the fp32 peak, the bf16 tensor-core operations over
    theirs, and the bytes over the memory rate."""
    t_ops = max(flops / PEAK_FP32_FLOPS, bf16_flops / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    row = {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if bf16_flops:
        row["bf16_flops"] = bf16_flops
    return row


def smooth_paths(n: int, L: int, C: int, gen: torch.Generator) -> torch.Tensor:
    """Joint-angle-like paths: cumulative steps of at most 0.1 (the
    flagship's |a|·dt), the shape of the τ paths the solve feeds K1."""
    steps = (torch.rand((n, L, C), generator=gen, device="cuda") - 0.5) * 0.2
    return torch.cumsum(steps, dim=1).contiguous()


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    from sigsvgd_tpu_torch.kernels import _build
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
    from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {stem: ptxas_functions(text) for stem, text in reports.items()}
    emit({"phase": "build", "build_s": time.perf_counter() - t0, "ptxas": ptxas})
    # every K1 and K2 instantiation (span templates 3 and 5 × C = 1..3,
    # template 3 × C = 4..8: kb.lanes_instantiations) and every K5 kernel
    # (forward and backward × span template) is in the report and spills
    # nothing, and K1 keeps no stack frame (no per-cell value in local
    # memory); K8's two kernels and every instantiation of K4, K6 and K7 as
    # K1's; the other sources' spills are reported, not gated
    spills = lambda fns: any(  # noqa: E731
        r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in fns.values())
    k1 = {f: r for f, r in ptxas["sigkernel_block"].items() if "block_lanes_kernel" in f}
    if (len(k1) != len(kb.lanes_instantiations()) or spills(k1)
            or any(r.get("stack_frame", 1) for r in k1.values())):
        raise AssertionError(f"K1's instantiations not all reported spill-free with "
                             f"no stack frame: {k1}")
    k2 = {f: r for f, r in ptxas["sigkernel_block3"].items() if "block3_kernel" in f}
    if len(k2) != len(kb3.lanes_instantiations()) or spills(k2):
        raise AssertionError(f"K2's instantiations not all reported spill-free: {k2}")
    k5 = {f: r for f, r in ptxas["sigkernel_tiled"].items() if "tiled_" in f}
    if len(k5) != 2 * len(kt.SPAN_TEMPLATES) or spills(k5):
        raise AssertionError(f"K5's kernels not all reported spill-free: {k5}")
    # K8's forward and backward (chain_kernel<false>, <true>): no spill, no
    # stack frame (the consumers' registers under setmaxnreg hold every
    # accumulator and fragment)
    k8 = {f: r for f, r in ptxas["mxu_chain"].items() if "chain_kernel" in f}
    if (sorted("ILb1E" in f for f in k8) != [False, True] or spills(k8)
            or any(r.get("stack_frame", 1) for r in k8.values())):
        raise AssertionError(f"K8's kernels not both reported spill-free with no "
                             f"stack frame: {k8}")
    # K3 keeps each pair's band rows, K4's forward and backward and K6 each
    # pair's fine rows in registers, K7 each pair's K, static and adjoint
    # rows: no spill, no stack frame at any instantiation (K3: each length
    # bucket × C inside L·C ≤ 128; K7: span 3 at C = 1..8 and span 5 at
    # C = 1..4, the forward values only and with the residual)
    for what, stem, tag, n in (
            ("K3", "sigkernel_block", "block_values_kernel", len(kb.values_instantiations())),
            ("K4's forward", "sigkernel_fused", "fused_fwd_lanes_kernel", 16),
            ("K4's backward", "sigkernel_fused", "fused_bwd_lanes_kernel", 16),
            ("K6", "sigkernel_fused", "fused_bwd_bf16_lanes_kernel", 8),
            ("K7's forward", "sigkernel_small", "small_fwd_lanes_kernel", 24),
            ("K7's backward", "sigkernel_small", "small_bwd_lanes_kernel", 12)):
        fns = {f: r for f, r in ptxas[stem].items() if tag in f}
        if (len(fns) != n or spills(fns)
                or any(r.get("stack_frame", 1) for r in fns.values())):
            raise AssertionError(f"{what}'s instantiations not all reported spill-free "
                                 f"with no stack frame: {fns}")
    return smi


def ptxas_functions(report: str) -> dict:
    """Registers, stack frame and spill bytes of each function in an ``nvcc
    -Xptxas -v`` report, by its mangled name."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", ln)
        if m:
            name = m.group(1)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
            if (f := re.search(r"(\d+) bytes stack frame", ln)):
                out[name]["stack_frame"] = int(f.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def sass_counts(lib, tag: str) -> dict:
    """Instructions of the function whose mangled name holds ``tag`` in the
    SASS of library ``lib`` (``cuobjdump``; empty where it is missing): by
    opcode (the 12 most frequent), in all, and in its longest loop (from a
    backward branch's target to the branch)."""
    import collections
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        if tag not in part.split("\n", 1)[0]:
            continue
        ins, labels, branches, pending = [], {}, [], []
        for ln in part.splitlines():
            if (lab := re.match(r"\s*(\.L_x_\d+):", ln)):
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", ln)
            if not m:
                continue
            addr = int(m.group(1), 16)
            labels.update((lab, addr) for lab in pending)
            pending = []
            ins.append(m.group(2))
            if m.group(2).startswith("BRA") and (
                    t := re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", m.group(3))):
                branches.append((addr, t.group(1) or int(t.group(2), 16)))
        loop = 0
        for addr, target in branches:
            tgt = labels.get(target) if isinstance(target, str) else target
            if tgt is not None and tgt < addr:
                loop = max(loop, (addr - tgt) // 16 + 1)
        ops = collections.Counter(ins)
        return {"all": len(ins), "loop": loop, **dict(ops.most_common(12))}
    return {}


def k3_issue_floor(n: int, sass: dict, bands: int) -> dict:
    """K3's issue floor, derived from its SASS: the instructions a pair (the
    band loop once a band, the rest once) issued at one a cycle on each of
    the card's 528 sub-partitions at its maximum SM clock, for the warps
    that hold a pair a ≤ b (a tile's 8 row × 16 column particles, 4 warps
    of 2 rows each)."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    if not sass:
        return {"issue_floor_ms": None}
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    tiles = kb._tile_list(n, kb.VALUES_TILE_COLS, "cpu").long()
    r = torch.arange(0, kb.TILE_ROWS, 2)
    # a warp (row pair r, r+1 of tile (I, J)) holds a pair if a ≤ b for its
    # lowest row and highest column inside [0, n)
    a = tiles[:, :1] * kb.TILE_ROWS + r
    b = torch.clamp(tiles[:, 1:] * kb.VALUES_TILE_COLS + kb.VALUES_TILE_COLS - 1, max=n - 1)
    warps = int(((a < n) & (a <= b)).sum())
    per_pair = sass["all"] - sass["loop"] + sass["loop"] * bands
    return {"sass_per_pair": per_pair, "sass_band_loop": sass["loop"], "active_warps": warps,
            "max_sm_mhz": mhz,
            "issue_floor_ms": warps * per_pair / (4 * 132 * mhz * 1e6) * 1e3}


def device_mib_outside_allocator(fn) -> float:
    """Device memory that ``fn`` takes outside PyTorch's caching allocator
    (for a first kernel launch: the module and its local-memory reserve)."""
    torch.cuda.synchronize()
    free0, res0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    fn()
    torch.cuda.synchronize()
    free1, res1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    return ((free0 - free1) - (res1 - res0)) / 2**20


# K1's and K2's shapes beyond the flagship's: the planner's 7-joint knots at
# depth 0 and 3 (uniform in the joint limits, its bandwidth 1.5), the block
# envelope's edges at C = 8 and C = 4 (L·C = 128), and a ragged C = 7
WIDE_SHAPES = ((1024, 3, 7), (1024, 16, 8), (1024, 32, 4), (333, 18, 7))
KNOT_BW = 1.5  # PlannerConfig().pathsig_bw


def block_inputs(n: int, L: int, C: int, gen: torch.Generator):
    """``(X, h)`` of a K1 or K2 case: the planner's knots at its bandwidth
    for [n, 3, 7], else smooth paths at h = 4."""
    if (L, C) == (3, 7):
        return uniform_knots(n, gen), KNOT_BW
    return smooth_paths(n, L, C, gen), 4.0


def shape_summary(row) -> dict:
    """A kernel's time, the twin's and the bound at one shape, for the
    kernel table."""
    return {k: row.get(k) for k in ("shape", "h", "kernel_ms", "plain_ms", "bound_ms",
                                    "bound_by", "k_max_abs_err", "dx_scaled_err_vs_fp64",
                                    "library_ms")}


def phase_k1():
    """K1 against its plain twin at the flagship shape, a ragged n, the
    L ≤ 64 instantiation (16 lanes a pair) and ``WIDE_SHAPES`` (C = 4..8);
    each also against the twin in fp64. K must be the twin's bit for bit
    (the statics and the forward round as the twin does, and a schedule does
    not change a cell's arithmetic); at n = 1024 K and dX bit for bit across
    two calls, the plan and the times (K1's, the twin's, the bound). Returns
    the flagship row, with the C > 3 rows' times under ``"by_shape"``."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for n, L, C in ((1024, 40, 2), (333, 40, 2), (40, 64, 3)) + WIDE_SHAPES:
        X, h = block_inputs(n, L, C, gen)
        out = []
        # the first launch of each instantiation: its device-memory footprint
        mib = device_mib_outside_allocator(
            lambda: out.extend(kb.block_gram_and_grad(X, h)))
        K, dX = out
        Kp, dXp = kb.block_gram_and_grad_plain(X, h)
        K64, dX64 = kb.block_gram_and_grad_plain(X.double(), h)
        torch.cuda.synchronize()
        k_err = (K - Kp).abs().max().item()
        dscale = dXp.abs().max().item()
        dx_err = ((dX - dXp).abs().max() / dscale).item()
        s64 = dX64.abs().max().item()
        finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
        tiles, blocks = kb.block_grid(n, L, C, X.device)
        plan = kb.block_plan(n, L, C, blocks)
        pairs = n * (n + 1) // 2
        row = {"phase": "k1_vs_plain", "shape": [n, L, C], "h": h,
               "k_max_abs_err": k_err, "k_bit_equal": bool(torch.equal(K, Kp)),
               "dx_scaled_max_abs_err": dx_err,
               "k_err_vs_fp64": {"kernel": (K.double() - K64).abs().max().item(),
                                 "plain": (Kp.double() - K64).abs().max().item()},
               "dx_scaled_err_vs_fp64": {
                   "kernel": ((dX.double() - dX64).abs().max() / s64).item(),
                   "plain": ((dXp.double() - dX64).abs().max() / s64).item()},
               "first_launch_mib_outside_allocator": mib,
               "plan": {"lanes_a_pair": plan.g, "span_template": plan.span,
                        "spans": list(plan.spans), "band_rows": plan.band_rows,
                        "bands": plan.bands, "tile": [plan.tile_rows, plan.tile_cols],
                        "pipeline_steps": plan.steps, "tiles": plan.tiles,
                        "blocks": plan.blocks, "scratch_mib": plan.scratch_mib,
                        "smem_bytes": plan.smem_bytes, "traffic_bytes": plan.traffic_bytes,
                        "traffic_bytes_a_pair": plan.traffic_bytes / pairs},
               "finite": finite}
        ok = finite and row["k_bit_equal"] and dx_err <= 5e-5 and plan.tiles == tiles.shape[0]
        del K64, dX64
        if n == 1024:
            K2, dX2 = kb.block_gram_and_grad(X, h)
            row["bitwise_repeatable"] = bool(torch.equal(K, K2) and torch.equal(dX, dX2))
            ok = ok and row["bitwise_repeatable"] and plan.tiles > blocks
            del K2, dX2
            kernel_ms = event_ms(lambda: kb.block_gram_and_grad(X, h), 5)
            plain_ms = event_ms(lambda: kb.block_gram_and_grad_plain(X, h), 1)
            row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                       **bound(kb.block_flops(n, L, C), kb.block_bytes(n, L, C)))
        rows[(n, L, C)] = row
        emit(row)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain twin or itself: {row}")
    return {**rows[(1024, 40, 2)], "by_shape": [
        {**shape_summary(rows[s]), "dx_scaled_err_vs_fp64":
         rows[s]["dx_scaled_err_vs_fp64"]["kernel"]} for s in WIDE_SHAPES if s[0] == 1024]}


def drive_solves(phase: str, prob, want: dict, n_solves: int, gram_stage,
                 generator=None, cost_shape=None) -> dict:
    """A few chained MPC solves of ``prob`` after a warm-up, with every hand
    kernel's launches counted around them (``want``: each wrapper that
    launches, by name, and its launches a solve; no other may launch), the
    stages timed apart and one more solve traced. ``generator`` gives the
    solves' random draws (action samples); ``cost_shape`` is the costs'
    shape, ``(OPT_STEPS, n_pol)`` unless given."""
    ctrl = prob.ctrl
    t0 = time.perf_counter()
    cs = ctrl.init(generator=torch.Generator(device="cuda").manual_seed(1))
    state = prob.q_start
    # warm-up solve (first-call allocations), not counted
    ctrl.forward(state, cs, generator=generator, opt_steps=OPT_STEPS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    finite = True
    solve_ms = []
    with Launches() as counted:
        for _ in range(n_solves):
            t1 = time.perf_counter()
            a_seq, cs, data = ctrl.forward(state, cs, generator=generator,
                                           opt_steps=OPT_STEPS)
            state = prob.model.step(state[None], a_seq[0:1])[0]
            torch.cuda.synchronize()
            solve_ms.append((time.perf_counter() - t1) * 1e3)
            finite &= bool(torch.isfinite(a_seq).all()
                           and torch.isfinite(cs.pol_mean).all()
                           and torch.isfinite(data.costs).all())
    launches = counted.counts
    shapes = (tuple(a_seq.shape), tuple(cs.pol_mean.shape), tuple(data.costs.shape))
    if shapes != ((ctrl.hz_len, 7), (ctrl.n_pol, ctrl.hz_len, 7),
                  cost_shape or (OPT_STEPS, ctrl.n_pol)):
        raise AssertionError(f"{phase}: unexpected output shapes {shapes}")
    if not finite:
        raise AssertionError(f"{phase}: non-finite output")
    counted.expect(f"{phase} ({n_solves} solves)",
                   **{name: per_solve * n_solves for name, per_solve in want.items()})

    # the stages bench.py separates, timed apart (launches not counted)
    pol0 = cs.pol_mean
    if ctrl.n_action_samples:
        eps = torch.randn((ctrl.n_action_samples,) + tuple(pol0.shape),
                          generator=generator, device="cuda")

        def stage_rollout():
            with torch.no_grad():
                ctrl._rollout_costs(state, pol0[None] + eps)

        stages = {"sampled_rollout_cost": host_ms(stage_rollout, 3)}
    else:
        def stage_rollout():
            pm = pol0.detach().requires_grad_(True)
            c, _tr = ctrl._rollout_costs(state, pm)
            torch.autograd.grad(c.sum(), pm)

        stages = {"rollout_cost_grad": host_ms(stage_rollout, 3)}
    stages.update(gram_stage(ctrl, state, pol0))
    row = {"phase": phase, "n_pol": ctrl.n_pol, "hz_len": ctrl.hz_len,
           "opt_steps": OPT_STEPS, "n_solves": n_solves,
           "kernel_mode": ctrl.kernel_mode,
           "n_action_samples": ctrl.n_action_samples,
           "ms_per_solve_median": statistics.median(solve_ms),
           "ms_per_solve_spread": [min(solve_ms), max(solve_ms)],
           "ms_per_solve_samples": solve_ms, "launches": launches,
           "stages_ms": stages,
           "traced_solve": traced_solve(ctrl, state, cs, generator),
           "setup_s": setup_s, "final_cost_min": data.costs[-1].min().item(),
           "finite": finite}
    if ctrl.kernel_mode == "signature":
        row.update(dyadic_order=ctrl.sig_kernel.dyadic_order,
                   calibration_bound=prob.calibration_bound)
    emit(row)
    return row


def sig_gram_stage(ctrl, state, pol0) -> dict:
    with torch.no_grad():
        _c, trs = ctrl._rollout_costs(state, pol0)
        tau = ctrl._tau(trs).contiguous()
    return {"sig_gram_adjoint": host_ms(lambda: ctrl.sig_kernel.gram_and_grad(tau), 3)}


def phase_flagship():
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40)
    if prob.ctrl.sig_kernel.dyadic_order != 0:
        raise AssertionError("calibration did not choose order 0")
    row = drive_solves("flagship_solve", prob, {"block_gram_and_grad": OPT_STEPS},
                       N_SOLVES, sig_gram_stage)
    # τ of two rollouts of fresh policy draws, for the λ=0 pair-list phases
    ctrl, taus = prob.ctrl, []
    for seed in (11, 12):
        cs = ctrl.init(generator=torch.Generator(device="cuda").manual_seed(seed))
        with torch.no_grad():
            trs = ctrl._rollout_costs(prob.q_start, cs.pol_mean)[1]
        taus.append(ctrl._tau(trs).contiguous())
    return row["launches"]["block_gram_and_grad"], ctrl.sig_kernel, taus


def mc_pullback_stage(ctrl, state, pol0) -> dict:
    """The MC solve's kernel terms: the rollout of the sampled offsets with
    autograd, τ averaged over the samples, ``gram_and_grad`` (K1) and the
    pull-back of dτ to the policies."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    offsets = torch.randn((ctrl.n_action_samples,) + tuple(pol0.shape),
                          generator=gen, device="cuda")
    return {"tau_gram_pullback": host_ms(
        lambda: ctrl._kernel_terms(pol0, state, None, offsets), 3)}


def phase_mc_solve():
    """bench.py's MC workload: the calibrated flagship controller with 10
    action samples (``replace(ctrl_sig, n_action_samples=10)``), its draws
    from a seeded CUDA generator: 2 K1 launches a solve."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40)
    if prob.ctrl.sig_kernel.dyadic_order != 0:
        raise AssertionError("calibration did not choose order 0")
    ctrl = dataclasses.replace(prob.ctrl, n_action_samples=MC_SAMPLES)
    prob = dataclasses.replace(prob, ctrl=ctrl)
    row = drive_solves("mc_solve", prob, {"block_gram_and_grad": OPT_STEPS}, N_SOLVES,
                       mc_pullback_stage,
                       generator=torch.Generator(device="cuda").manual_seed(3),
                       cost_shape=(OPT_STEPS, MC_SAMPLES, ctrl.n_pol))
    return row["launches"]["block_gram_and_grad"]


def phase_mc_small_vs_cpu():
    """The port's MC solve at 64 policies, H = 40 and 10 samples, on the
    card (K1) and on the CPU (K1's twin) with the same given draws: the
    first step's costs (rtol 1e-5), K and the repulsion (K1's atol 3e-5 and
    scaled 5e-5, ``tests/test_torch_dust.py``'s λ=0 mode), the weights'
    argmax and the new policies (atol 2e-5) on the elements whose φ (the
    CPU's, each step) stayed above 1e-4·max|φ|, which must be over 99%."""
    from sigsvgd_tpu_torch.controllers.dust import DuStDraws
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    n, H = 64, 40
    gen = torch.Generator().manual_seed(21)
    pol = torch.rand((n, H, 7), generator=gen) * 4.0 - 2.0
    eps = torch.randn((OPT_STEPS, MC_SAMPLES, n, H, 7), generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        prob = build_arm_mpc(device=dev, n_pol=n, hz_len=H, dyadic_order=0,
                             calibrate=False)
        ctrl = dataclasses.replace(prob.ctrl, n_action_samples=MC_SAMPLES)
        cs = ctrl.init(pol_mean=pol.to(dev))
        with Launches() as counted:
            a_seq, cs2, data = ctrl.forward(prob.q_start, cs, opt_steps=OPT_STEPS,
                                            draws=DuStDraws(actions=eps.to(dev)))
        launches = counted.counts["block_gram_and_grad"]
        prior = ParticleGMM(cs.pol_mean.reshape(n, -1), ctrl._prior_var(),
                            cs.prior_weights)
        score, _tr = ctrl._score(cs.pol_mean, prob.q_start, prior, None, eps[0].to(dev))
        keep = torch.ones((n, H, 7), dtype=torch.bool)
        if dev == "cpu":
            sampler = ctrl._sampler()
            for t in range(OPT_STEPS):
                s_t = ctrl._score(data.trace[t], prob.q_start, prior, None, eps[t])[0]
                phi = sampler.velocity(data.trace[t], s_t, t)[0].abs()
                keep &= phi > 1e-4 * phi.max()
        out[dev] = {"costs": data.costs[0].cpu(), "k": score.k_xx.cpu(),
                    "grad_k": score.grad_k.cpu(), "i_star": int(torch.argmax(data.pol_weights)),
                    "a_seq": a_seq.cpu(), "pol": cs2.pol_mean.cpu(), "launches": launches,
                    "keep": keep, "finite": bool(torch.isfinite(cs2.pol_mean).all())}
    g, c = out["cuda"], out["cpu"]
    keep = c["keep"]
    rolled_keep = torch.cat([keep[:, 1:], keep[:, -1:]], dim=1)
    row = {"phase": "mc_small_vs_cpu", "n_pol": n, "hz_len": H, "n_action_samples": MC_SAMPLES,
           "k1_launches": g["launches"],
           "costs_rel": ((g["costs"] - c["costs"]).abs() / c["costs"].abs()).max().item(),
           "k_abs": (g["k"] - c["k"]).abs().max().item(),
           "grad_k_scaled": ((g["grad_k"] - c["grad_k"]).abs().max()
                             / c["grad_k"].abs().max()).item(),
           "i_star": [g["i_star"], c["i_star"]],
           "kept_share": keep.float().mean().item(),
           "a_seq_abs": (g["a_seq"] - c["a_seq"]).abs()[keep[c["i_star"]]].max().item(),
           "pol_abs": (g["pol"] - c["pol"]).abs()[rolled_keep].max().item()}
    emit(row)
    ok = (g["launches"] == OPT_STEPS and c["launches"] == 0 and g["finite"] and c["finite"]
          and row["costs_rel"] <= 1e-5 and row["k_abs"] <= 3e-5
          and row["grad_k_scaled"] <= 5e-5 and g["i_star"] == c["i_star"]
          and row["kept_share"] > 0.99 and row["a_seq_abs"] <= 2e-5
          and row["pol_abs"] <= 2e-5)
    if not ok:
        raise AssertionError(f"the card's MC solve disagrees with the CPU's: {row}")


def phase_k2():
    """K2 against its plain twin at small shapes and at the flagship shape:
    K against the fp32 twin (the values-only twin at the flagship shape),
    dX against the twin in fp64; the first launch's memory; its time and
    the twin's at the flagship shape."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    gen = torch.Generator(device="cuda").manual_seed(3)
    h = 4.0
    k_tol, dx_tol = K2_TOL
    first = True
    for n, L, C in ((128, 40, 2), (77, 40, 2), (40, 49, 3)):
        X = smooth_paths(n, L, C, gen)
        res = []
        mib = device_mib_outside_allocator(
            lambda: res.extend(kb3.block3_gram_and_grad(X, h)))
        K, dX = res
        Kp, dXp = kb3.block3_gram_and_grad_plain(X, h)
        K64, dX64 = kb3.block3_gram_and_grad_plain(X.double(), h)
        torch.cuda.synchronize()
        k_err = (K - Kp).abs().max().item()
        s64 = dX64.abs().max().item()
        # dX is held against the twin in fp64: at λ=3 the fp32 twin's own dX
        # is ~4e-4 (scaled) from it, as far as the tolerance
        dx_err = ((dX.double() - dX64).abs().max() / s64).item()
        finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
        row = {"phase": "k2_vs_plain", "shape": [n, L, C], "h": h,
               "k_max_abs_err": k_err, "dx_scaled_err_vs_fp64": dx_err,
               "dx_scaled_err_vs_fp32_plain":
                   ((dX - dXp).abs().max() / dXp.abs().max()).item(),
               "plain_dx_scaled_err_vs_fp64":
                   ((dXp.double() - dX64).abs().max() / s64).item(),
               "k_max": K64.max().item(),
               "k_err_vs_fp64": {"kernel": (K.double() - K64).abs().max().item(),
                                 "plain": (Kp.double() - K64).abs().max().item()},
               "finite": finite}
        if first:
            row["first_launch_mib_outside_allocator"] = mib
            first = False
        del K64, dX64
        if n == 128:
            row["kernel_ms"] = event_ms(lambda: kb3.block3_gram_and_grad(X, h), 3)
            row["plain_ms"] = event_ms(lambda: kb3.block3_gram_and_grad_plain(X, h), 1)
        emit(row)
        if not (finite and k_err <= k_tol and dx_err <= dx_tol):
            raise AssertionError(f"K2 disagrees with its plain twin (K) or the "
                                 f"twin in fp64 (dX): {row}")

    # the flagship shape: K2's persistent blocks each walk several tiles, so
    # this is where per-thread scratch and shared slots are reused from one
    # tile to the next. The full twins (fp64 for the check, fp32 for the
    # plain time) take the pairs a chunk at a time to bound their memory.
    n, L, C = 1024, 40, 2
    X = smooth_paths(n, L, C, gen)
    tiles, blocks = kb3.block3_grid(n, L, C, X.device)
    n_tiles = tiles.shape[0]
    plan = kb3.block3_plan(n, L, C, blocks)
    if n_tiles <= blocks or n_tiles != plan.tiles:
        raise AssertionError(f"K2 at {[n, L, C]}: {n_tiles} tiles over {blocks} "
                             f"blocks (the plan: {plan.tiles}), so no block takes "
                             "a second tile")
    K, dX = kb3.block3_gram_and_grad(X, h)
    Kb, dXb = kb3.block3_gram_and_grad(X, h)
    repeatable = bool(torch.equal(K, Kb) and torch.equal(dX, dXb))
    del Kb, dXb
    Kv = kb3.block3_gram_plain(X, h)
    k_err = (K - Kv).abs().max().item()
    t0 = time.perf_counter()
    K64, dX64 = kb3.block3_gram_and_grad_plain(X.double(), h, pairs_per_chunk=4096)
    torch.cuda.synchronize()
    fp64_twin_s = time.perf_counter() - t0
    s64 = dX64.abs().max().item()
    dx_err = ((dX.double() - dX64).abs().max() / s64).item()
    finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
    plain = []
    plain_ms = event_ms(lambda: plain.extend(
        kb3.block3_gram_and_grad_plain(X, h, pairs_per_chunk=8192)), 1)
    Kp, dXp = plain
    pairs = n * (n + 1) // 2
    row = {"phase": "k2_vs_plain", "shape": [n, L, C], "h": h,
           "tiles": n_tiles, "persistent_blocks": blocks,
           "plan": k2_plan_row(plan, pairs),
           "bitwise_repeatable": repeatable,
           "k_max_abs_err": k_err, "dx_scaled_err_vs_fp64": dx_err,
           "compared": "K against the values-only twin, dX against the twin in fp64",
           "dx_scaled_err_vs_fp32_plain":
               ((dX - dXp).abs().max() / dXp.abs().max()).item(),
           "plain_dx_scaled_err_vs_fp64": ((dXp.double() - dX64).abs().max() / s64).item(),
           "k_err_vs_fp64": {"kernel": (K.double() - K64).abs().max().item(),
                             "plain": (Kp.double() - K64).abs().max().item(),
                             "values_only_plain": (Kv.double() - K64).abs().max().item()},
           "fp64_twin_s": fp64_twin_s, "finite": finite}
    del K64, dX64, Kp, dXp, Kv, plain
    torch.cuda.reset_peak_memory_stats()
    row["kernel_ms"] = event_ms(lambda: kb3.block3_gram_and_grad(X, h), 3)
    row["peak_allocated_mib"] = torch.cuda.max_memory_allocated() / 2**20
    row["plain_ms"] = plain_ms
    row["library_ms"] = None
    row.update(bound(kb3.block3_flops(n, L, C), kb3.block3_bytes(n, L, C)))
    emit(row)
    if not (finite and k_err <= k_tol and dx_err <= dx_tol and repeatable):
        raise AssertionError(f"K2 disagrees with its values-only twin (K) or the "
                             f"twin in fp64 (dX), or with itself: {row}")
    return {**row, "by_shape": [shape_summary(r) for r in phase_k2_wide(gen)
                                if r["shape"][0] == 1024]}


def k2_plan_row(plan, pairs: int) -> dict:
    """K2's plan (``block3_plan``) as a phase row records it."""
    return {"lanes_a_pair": plan.g, "span_template": plan.span, "spans": list(plan.spans),
            "tile": [plan.tile_rows, plan.tile_cols], "pipeline_steps": plan.steps,
            "tiles": plan.tiles, "blocks": plan.blocks, "scratch_mib": plan.scratch_mib,
            "smem_bytes": plan.smem_bytes, "traffic_bytes": plan.traffic_bytes,
            "traffic_bytes_a_pair": plan.traffic_bytes / pairs}


def phase_k2_wide(gen: torch.Generator) -> list:
    """K2 at ``WIDE_SHAPES`` (C = 4..8, span template 3): K against the fp32
    twin at atol 1e-4 and dX against the twin in fp64 at scaled 4e-4
    (``K2_TOL``); at n = 1024 K and dX bit for bit across two calls, the
    plan, K2's time, the fp32 twin's (by chunks of pairs) and the bound."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    k_tol, dx_tol = K2_TOL
    rows = []
    for n, L, C in WIDE_SHAPES:
        X, h = block_inputs(n, L, C, gen)
        K, dX = kb3.block3_gram_and_grad(X, h)
        chunk = 4096 if L > 8 else 65536  # the twin stores ~6·(8L)² floats a pair
        plain = []
        plain_ms = event_ms(lambda: plain.extend(
            kb3.block3_gram_and_grad_plain(X, h, pairs_per_chunk=chunk)), 1)
        Kp, dXp = plain
        _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), h, pairs_per_chunk=chunk)
        torch.cuda.synchronize()
        k_err = (K - Kp).abs().max().item()
        s64 = dX64.abs().max().item()
        dx_err = ((dX.double() - dX64).abs().max() / s64).item()
        tiles, blocks = kb3.block3_grid(n, L, C, X.device)
        plan = kb3.block3_plan(n, L, C, blocks)
        row = {"phase": "k2_vs_plain", "shape": [n, L, C], "h": h,
               "k_max_abs_err": k_err, "dx_scaled_err_vs_fp64": dx_err,
               "dx_scaled_err_vs_fp32_plain":
                   ((dX - dXp).abs().max() / dXp.abs().max()).item(),
               "plain_dx_scaled_err_vs_fp64": ((dXp.double() - dX64).abs().max() / s64).item(),
               "plan": k2_plan_row(plan, n * (n + 1) // 2),
               "finite": bool(torch.isfinite(K).all() and torch.isfinite(dX).all())}
        del dX64, Kp, dXp, plain
        ok = row["finite"] and k_err <= k_tol and dx_err <= dx_tol and plan.tiles == tiles.shape[0]
        if n == 1024:
            Kb, dXb = kb3.block3_gram_and_grad(X, h)
            row["bitwise_repeatable"] = bool(torch.equal(K, Kb) and torch.equal(dX, dXb))
            ok = ok and row["bitwise_repeatable"]
            del Kb, dXb
            row.update(kernel_ms=event_ms(lambda: kb3.block3_gram_and_grad(X, h), 3),
                       plain_ms=plain_ms, library_ms=None,
                       **bound(kb3.block3_flops(n, L, C), kb3.block3_bytes(n, L, C)))
        emit(row)
        if not ok:
            raise AssertionError(f"K2 disagrees with its twin (K), the twin in fp64 (dX) "
                                 f"or itself: {row}")
        rows.append(row)
    return rows


def phase_pinned():
    """The pinned order-3 solve with K2, then the same solve with the bf16
    adjoint (the pair list: K4's forward and K6), in one call."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    launches = {}
    for phase, prec, want in (
            ("pinned_solve", "fp32", {"block3_gram_and_grad": OPT_STEPS}),
            ("bf16_pinned_solve", "bf16",
             {"fused_forward": OPT_STEPS, "fused_backward_bf16": OPT_STEPS})):
        prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, calibrate=False,
                             grad_precision=prec)
        if prob.ctrl.sig_kernel.dyadic_order != 3:
            raise AssertionError("the pinned controller is not at order 3")
        row = drive_solves(phase, prob, want, N_SOLVES, sig_gram_stage)
        launches.update({(phase, k): v for k, v in row["launches"].items()})
    return launches


def graph_ms(fn, iters: int = 200) -> float:
    """Mean time of ``fn`` replayed from a CUDA graph, by CUDA events: the
    device's time for a call without the host's dispatch (the few µs
    between the graph's kernels stay in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the warm-up a capture wants, on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(graph.replay, iters)


def in_turns(kernel, library, iters: int = 200) -> dict:
    """The kernel and the library call timed in turns, library, kernel,
    kernel, library, twice over: each turn CUDA events over ``iters`` calls
    after a warm-up. Medians and every turn."""
    kernel()
    library()
    torch.cuda.synchronize()
    k, lib = [], []
    for _ in range(2):
        lib.append(event_ms(library, iters))
        k.extend((event_ms(kernel, iters), event_ms(kernel, iters)))
        lib.append(event_ms(library, iters))
    return {"kernel_ms": statistics.median(k), "library_ms": statistics.median(lib),
            "kernel_turns_ms": k, "library_turns_ms": lib}


K9_TIMED = ((1024, 280), (1024, 840), (1024, 1400))  # the policy solve's D, H = 120, H = 200


def k9_inputs(gen: torch.Generator, N: int, D: int, scale: float) -> tuple:
    """Policies as the solve holds them (uniform in the action range),
    scores ``randn × scale`` and the sampler's median bandwidth."""
    from sigsvgd_tpu_torch.utils.math import bw_median, pw_dist_sq

    x = torch.rand((N, D), generator=gen, device="cuda") * 4.0 - 2.0
    s = torch.randn((N, D), generator=gen, device="cuda") * scale
    return x, s, bw_median(pw_dist_sq(x, x))


def k9_bound(N: int, D: int) -> dict:
    """K9's bound, the least time the card could take: its three products
    on the TF32 tensor cores in 3xTF32 (three passes each; X·Xᵀ counted
    once for its symmetry, its upper triangle with the diagonal) over 495
    TFLOP/s, or x and s read and φ written once over the memory rate,
    whichever is longer. The fp32 CUDA-core bound of the three products
    beside it."""
    from sigsvgd_tpu_torch.kernels import svgd_velocity as kv

    tf32_flops = 3.0 * (D * N * (N + 1) + 2 * 2.0 * N * N * D)
    t_ops = tf32_flops / PEAK_TF32_FLOPS
    t_bytes = kv.velocity_bytes(N, D) / PEAK_BYTES
    return {"tf32_flops": tf32_flops, "bytes": kv.velocity_bytes(N, D),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "issued_tf32_flops": kv.velocity_tc_flops(N, D), "fp32_flops": kv.velocity_flops(N, D),
            "fp32_bound_ms": kv.velocity_flops(N, D) / PEAK_FP32_FLOPS * 1e3}


def phase_k9_timing() -> dict:
    """K9 and the library call (its twin) at each [1024, D], measured in a
    fresh process (``chip_smoke.py --k9-timing``, :func:`k9_timing`), one
    row a shape: fresh, because a profiler session earlier in a process
    slows its host dispatch, and this one's phases trace."""
    proc = subprocess.run([sys.executable, __file__, "--k9-timing"], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"the K9 timing process failed (exit {proc.returncode})")
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            rows[tuple(row["shape"])] = row
            emit(row)
    if sorted(rows) != sorted(K9_TIMED):
        raise AssertionError(f"the K9 timing process timed {sorted(rows)}")
    return rows


def k9_timing() -> None:
    """The K9 timing process: at each [1024, D] kernel and library call
    timed in turns (library, kernel, kernel, library, twice, each turn 200
    calls), then each replayed from a CUDA graph (:func:`graph_ms`), which
    leaves out the host's dispatch. Not by ``torch.profiler``: a session
    of 20 calls here recorded 18 of K9's 40 kernels."""
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    from sigsvgd_tpu_torch.kernels import svgd_velocity as kv

    gen = torch.Generator(device="cuda").manual_seed(8)
    for N, D in K9_TIMED:
        x, s, h = k9_inputs(gen, N, D, 1.0)

        def kernel():
            return kv.fused_rbf_velocity(x, s, h)

        def library():
            return kv.rbf_velocity_plain(x, s, h)

        emit({"phase": "k9_timing", "shape": [N, D], **in_turns(kernel, library),
              "kernel_graph_ms": graph_ms(kernel), "library_graph_ms": graph_ms(library)})


MAZE_STEPS = 150  # maze_episode's cap: the goal or a crash ends it sooner
MAZE_SETTLE = 3  # maze_episode's first steps, left out of its median
MAZE_TOL = (2e-5, 1e-3, 1e-4)  # states, actions, MPF particles atol, card against CPU
PENDULUM_STEPS = 50


def phase_maze() -> dict:
    """The particle maze and the pendulum runners, in a fresh process
    (``chip_smoke.py --maze``, :func:`maze_phases`): these paths are
    host-bound, and a profiler session earlier in a process slows its host
    dispatch. Its rows, by phase (``k2_maze_shape`` by n)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--maze"], capture_output=True,
                          text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            key = row["phase"] + (f" {row['shape'][0]}" if "shape" in row else "")
            rows.setdefault(key, []).append(row)
            emit(row)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"the maze process failed (exit {proc.returncode})")
    want = {"k2_maze_shape 35", "k2_maze_shape 36", "pendulum_dust", "pendulum_disco",
            "maze_small_vs_cpu", "maze_episode"}
    if set(rows) != want:
        raise AssertionError(f"the maze process gave the phases {sorted(rows)}")
    emit({"phase": "maze_process", "wall_s": wall_s})
    return rows


def maze_phases() -> None:
    """The maze process: K2 at the maze's shapes, the pendulum's DuSt and
    DISCO runs, a short maze episode on the card against the CPU, then the
    maze episode (its traced step last)."""
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)

    phase_k2_maze_shape()
    phase_pendulum("dust")
    phase_pendulum("disco")
    phase_maze_small_vs_cpu()
    phase_maze_episode()


def maze_tau(n: int):
    """τ of the maze's sampled rollouts on the card: n paths of 30 XY points
    (``MazeConfig()`` with ``n - 5`` random policies and the 5 primitives,
    averaged over 10 action samples from the start), and the signature
    kernel's bandwidth √32."""
    from sigsvgd_tpu_torch.experiments import maze

    cfg = maze.MazeConfig(n_policies=n - maze.N_PRIM, steps=1)
    model = maze.make_model(cfg, "cuda")
    ctrl = maze.build_controller(cfg, model)
    draws = maze.sample_draws(cfg, torch.Generator(device="cuda").manual_seed(n))
    cs = ctrl.init(pol_mean=draws.pol_mean,
                   action_primitives=maze.action_primitives(cfg.horizon, "cuda"))
    eps = draws.steps[0].actions[0] @ torch.linalg.cholesky(ctrl._pol_cov()).T
    state = torch.tensor(model.init_state, device="cuda")
    with torch.no_grad():
        trajs = ctrl._rollout_costs(state, cs.pol_mean[None] + eps)[1]
    return ctrl._tau(trajs).contiguous(), ctrl.sig_kernel.bandwidth


def phase_k2_maze_shape() -> dict:
    """K2 at the maze's [35, 30, 2] (630 pairs: a ragged last tile row and
    diagonal tile) and [36, 30, 2], on the maze's own τ at h = √32: K
    against the fp32 twin at ``K2_TOL`` (atol 1e-4); dX against the twin in
    fp64, as ``k2_vs_plain`` holds it, at ``K2_TOL``'s scaled 4e-4 or, where
    the fp32 twin is itself farther from fp64, at 1.1 times the twin's own
    distance: on these paths (unit-size steps at h = √32) the fp32 twin's
    dX was 9.19e-4 of its max from fp64 on the card (6.7e-4 on the CPU's τ),
    K2's 9.19e-4, and the two 5.6e-4 apart. Times by CUDA events (the
    wrapper's dispatch inside), the plan and the bound."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    k_tol, dx_tol = K2_TOL
    rows = {}
    for n in (35, 36):
        X, h = maze_tau(n)
        _, L, C = X.shape
        K, dX = kb3.block3_gram_and_grad(X, h)
        Kp, dXp = kb3.block3_gram_and_grad_plain(X, h)
        K64, dX64 = kb3.block3_gram_and_grad_plain(X.double(), h)
        torch.cuda.synchronize()
        s64 = dX64.abs().max().item()
        tiles, blocks = kb3.block3_grid(n, L, C, X.device)
        plan = kb3.block3_plan(n, L, C, blocks)
        row = {"phase": "k2_maze_shape", "shape": [n, L, C], "h": h,
               "pairs": n * (n + 1) // 2, "tiles": tiles.shape[0],
               "persistent_blocks": blocks,
               "plan": {"lanes_a_pair": plan.g, "spans": list(plan.spans),
                        "tile": [plan.tile_rows, plan.tile_cols], "blocks": plan.blocks,
                        "scratch_mib": plan.scratch_mib, "smem_bytes": plan.smem_bytes,
                        "traffic_bytes": plan.traffic_bytes},
               "k_max_abs_err": (K - Kp).abs().max().item(),
               "dx_scaled_err_vs_fp32_plain":
                   ((dX - dXp).abs().max() / dXp.abs().max()).item(),
               "dx_scaled_err_vs_fp64": ((dX.double() - dX64).abs().max() / s64).item(),
               "plain_dx_scaled_err_vs_fp64":
                   ((dXp.double() - dX64).abs().max() / s64).item(),
               "k_err_vs_fp64": (K.double() - K64).abs().max().item(),
               "symmetric": bool(torch.equal(K, K.T)),
               "finite": bool(torch.isfinite(K).all() and torch.isfinite(dX).all())}
        row["kernel_ms"] = event_ms(lambda: kb3.block3_gram_and_grad(X, h), 20)
        row["plain_ms"] = event_ms(lambda: kb3.block3_gram_and_grad_plain(X, h), 3)
        row["library_ms"] = None
        row.update(bound(kb3.block3_flops(n, L, C), kb3.block3_bytes(n, L, C)))
        emit(row)
        row["dx_bound_vs_fp64"] = max(dx_tol, 1.1 * row["plain_dx_scaled_err_vs_fp64"])
        if not (row["finite"] and row["symmetric"] and row["k_max_abs_err"] <= k_tol
                and row["dx_scaled_err_vs_fp64"] <= row["dx_bound_vs_fp64"]):
            raise AssertionError(f"K2 at the maze's shape disagrees with its twin: {row}")
        rows[n] = row
    return rows


def phase_pendulum(which: str) -> dict:
    """A swing-up from hanging down, ``PENDULUM_STEPS`` closed-loop steps on
    the card after a 2-step warm-up: ``run_dust`` (1 policy, H = 20, 5 Adam
    steps, policy mode) or ``run_disco`` at its full width (256 actions,
    H = 30, 4 parameter samples): ms a step (the run's wall over its steps;
    the states stay on the card until the end), no hand kernel launched."""
    from sigsvgd_tpu_torch.experiments import pendulum

    run = pendulum.run_dust if which == "dust" else pendulum.run_disco
    run(steps=2, device="cuda")
    with Launches() as counted:
        res = run(steps=PENDULUM_STEPS, device="cuda")
    row = {"phase": f"pendulum_{which}", "steps": PENDULUM_STEPS,
           "ms_per_step": res["wall_clock_s"] * 1e3 / PENDULUM_STEPS,
           "wall_s": res["wall_clock_s"],
           "final_upright_error_rad": res["final_upright_error_rad"],
           "launches": counted.counts,
           "finite": bool(np.isfinite(res["trajectory"]).all())}
    emit(row)
    if not row["finite"]:
        raise AssertionError(f"the pendulum's {which} run failed: {row}")
    counted.expect(f"pendulum_{which}")
    return row


def phase_maze_small_vs_cpu() -> list:
    """A 3-step maze episode (MPF on; 11 + 5 policies, H = 30, 10 action
    samples) with the RBF kernel and with the signature kernel, on the card
    and on the CPU from the same given draws: states, actions and the MPF's
    particles within ``MAZE_TOL``, the same steps and crash flags, K2 twice a
    step on the card with the signature kernel, never on the CPU."""
    from sigsvgd_tpu_torch.experiments import maze

    rows = []
    for kernel in ("rbf", "signature"):
        cfg = maze.MazeConfig(kernel=kernel, use_mpf=True, n_policies=11, steps=3)
        draws = maze.sample_draws(cfg, torch.Generator().manual_seed(5))
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            with Launches() as counted:
                res = maze.run_episode(cfg, 0, device=dev, draws=draws.to(dev))
            out[dev] = (res, counted.counts["block3_gram_and_grad"],
                        time.perf_counter() - t0)
        (g, lg, tg), (c, lc, tc) = out["cuda"], out["cpu"]
        row = {"phase": "maze_small_vs_cpu", "kernel": kernel,
               "n_paths": cfg.n_policies + maze.N_PRIM, "horizon": cfg.horizon,
               "steps": [g["steps"], c["steps"]], "crashed": [g["crashed"], c["crashed"]],
               "state_abs": float(np.abs(g["trajectory"] - c["trajectory"]).max()),
               "action_abs": float(np.abs(g["actions"] - c["actions"]).max()),
               "particles_abs": float(np.abs(g["dyn_particles"] - c["dyn_particles"]).max()),
               "tol_state_action_particles": list(MAZE_TOL),
               "k2_launches": [lg, lc], "wall_s": [tg, tc]}
        emit(row)
        want_k2 = 2 * g["steps"] if kernel == "signature" else 0
        ok = (g["steps"] == c["steps"] and g["crashed"] == c["crashed"]
              and row["state_abs"] <= MAZE_TOL[0] and row["action_abs"] <= MAZE_TOL[1]
              and row["particles_abs"] <= MAZE_TOL[2] and lg == want_k2 and lc == 0)
        if not ok:
            raise AssertionError(f"the card's maze episode disagrees with the CPU's: {row}")
        rows.append(row)
    return rows


def phase_maze_episode() -> dict:
    """The port's ``run_episode`` at ``MazeConfig()``'s full width with the
    signature kernel and the MPF (35 paths, H = 30, 10 action samples, 2
    Adam steps; 50 particles, 20 Stein steps), its draws from a seeded
    generator on the card, for up to ``MAZE_STEPS`` steps or to the goal
    or a crash, after a 2-step warm-up episode: ms a control step (each
    step's wall: the solve, the real step, the MPF update, the one fetch;
    the median and spread after the first ``MAZE_SETTLE``), K2 launched
    exactly twice a step and no other hand kernel; then from the start,
    apart, one solve and real step and one MPF update (host clock, 5 each),
    and both traced once."""
    from sigsvgd_tpu_torch.experiments import maze
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    cfg = maze.MazeConfig(kernel="signature", use_mpf=True, steps=MAZE_STEPS)
    t0 = time.perf_counter()
    maze.run_episode(dataclasses.replace(cfg, steps=2), 0, device="cuda")
    warm_s = time.perf_counter() - t0
    with Launches() as counted:
        res = maze.run_episode(cfg, 1, device="cuda")
    launches = counted.counts
    steps = res["steps"]
    step_ms = [t * 1e3 for t in res["step_wall_s"]]
    settled = step_ms[MAZE_SETTLE:] or step_ms
    post = res["dyn_particles"][-1]

    model = maze.make_model(cfg, "cuda")
    ctrl = maze.build_controller(cfg, model)
    mpf = maze.build_mpf(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cs = ctrl.init(generator=gen, action_primitives=maze.action_primitives(cfg.horizon, "cuda"))
    state = torch.tensor(model.init_state, device="cuda")
    ms = mpf.init(torch.tensor(post, device="cuda"), state)
    prior = ParticleGMM(ms.particles, ms.prior_bw**2, torch.ones(cfg.mpf_n_particles,
                                                                  device="cuda"))

    def solve():
        a_seq = ctrl.forward(state, cs, prior, gen, opt_steps=cfg.opt_steps)[0]
        return a_seq[0], model.step(state[None], a_seq[0][None])[0]

    action, nxt = solve()

    def observe():
        return mpf.observe(ms, action, nxt, n_steps=cfg.mpf_steps)

    row = {"phase": "maze_episode", "n_paths": ctrl.n_total, "horizon": cfg.horizon,
           "action_samples": cfg.action_samples, "opt_steps": cfg.opt_steps,
           "mpf_particles": cfg.mpf_n_particles, "mpf_steps": cfg.mpf_steps,
           "steps": steps, "reached_goal": res["reached_goal"], "crashed": res["crashed"],
           "ms_per_step_median": statistics.median(settled),
           "ms_per_step_spread": [min(settled), max(settled)],
           "ms_first_steps": step_ms[:MAZE_SETTLE], "ms_per_step_samples": step_ms,
           "episode_wall_s": res["wall_clock_s"], "warm_up_s": warm_s,
           "launches": launches,
           "k2_launches_per_step": launches["block3_gram_and_grad"] / max(steps, 1),
           "final_state": res["trajectory"][-1].tolist(),
           "total_cost": float(res["costs"].sum()),
           "mass_true": model.mass,
           "mass_posterior_mean": float(np.exp(post.mean())),
           "mass_posterior_arith_mean": float(np.exp(post).mean()),
           "solve_and_step_ms": host_ms(solve, 5), "mpf_observe_ms": host_ms(observe, 5),
           "traced_step": traced(lambda: (solve(), observe()))}
    emit(row)
    if (steps < 1 or not np.isfinite(res["trajectory"]).all()
            or not np.isfinite(post).all()):
        raise AssertionError(f"the maze episode failed: {row}")
    counted.expect(f"maze_episode ({steps} steps, 2 K2 a step)",
                   block3_gram_and_grad=2 * steps)
    return row


PLANNING_SWEEP_TOL = {
    "sweep_knots": (1e-4, 1e-5),  # rtol, atol of the sweep cell's knots after 10 iterations
    "field_paths": 1e-4,  # atol of the obstacle field's paths after 5 pathsig iterations
    "ik_q": 1e-4,  # atol of the IK's configurations after 100 iterations
}
QUICK_CONFIG = dict(n_iter=60, batch=8, depth=3, timesteps=60)  # the README's --quick
FULL_TIMED_ITERS = 10  # robot_planning_full's timed window, after its run


def phase_planning() -> dict:
    """The arm-planning sweep and the obstacle field, in a fresh process
    (``chip_smoke.py --planning``, :func:`planning_phases`; host-bound paths,
    kept apart from the profiler sessions of this process). Its rows, by
    phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--planning"], capture_output=True,
                          text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if "phase" in row:  # the sweep's own rows are printed inside phases
                rows.setdefault(row["phase"], []).append(row)
                emit(row)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"the planning process failed (exit {proc.returncode})")
    want = {"k4_sweep_shape", "k2_field_shape", "k8_sweep_shape", "robot_planning_quick",
            "robot_planning_full", "obstacle_field", "planning_small_vs_cpu"}
    if set(rows) != want:
        raise AssertionError(f"the planning process gave the phases {sorted(rows)}")
    emit({"phase": "planning_process", "wall_s": wall_s})
    return {k: v[0] for k, v in rows.items()}


def planning_phases() -> None:
    """The planning process: K4, K2 and K8 at the shapes these paths give
    them, then the quick sweep, the full-width learned sweep cell, the
    obstacle field, and the card against the CPU."""
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)

    phase_k4_sweep_shape()
    phase_k2_field_shape()
    phase_k8_sweep_shape()
    phase_robot_planning_quick()
    phase_robot_planning_full()
    phase_obstacle_field()
    phase_planning_sweep_small_vs_cpu()


def uniform_knots(n: int, gen: torch.Generator) -> torch.Tensor:
    """Knot particles ``[n, 3, 7]`` on the card, as ``run_optimisation``
    draws them."""
    from sigsvgd_tpu_torch.experiments import planning
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

    return planning.uniform_knots(PandaRobot.create(device="cuda"), n, 3, gen)


def shape_row(phase, shape, err, kernel_ms, plain_ms, b, **extra) -> dict:
    row = {"phase": phase, "shape": shape, "max_abs_err": err, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": None, **b, **extra}
    emit(row)
    return row


def phase_k4_sweep_shape() -> dict:
    """K4's forward and fp32 backward, called directly, on the quick sweep's
    pathsig Gram: the upper-triangle list of knots [8, 3, 7] (36 pairs,
    ly1 = 2) at h = 1.5, against the twin: K atol 1e-4 against the fp32
    twin, dX (summed per path) scaled 4e-4 against the twin in fp64
    (``K4_TOL``); times by CUDA events, both parts' bounds. The sweep itself
    runs K2 on these knots (``robot_planning_quick``); this is K4 at the
    pair list the sweep took before K2 covered the block3 envelope."""
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

    X = uniform_knots(8, torch.Generator(device="cuda").manual_seed(40))
    xt, yt, g, iu, ju = triu_tiles(X, 1.5)
    P, Lx, Ly, C = xt.shape[2], xt.shape[0], yt.shape[0], xt.shape[1]
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    dx, dy = kf.fused_backward(xt, yt, ck, rc, g)
    kp, _, _ = kf.fused_pairs_plain(xt, yt, g)
    _, dx64, dy64 = kf.fused_pairs_plain(xt.double(), yt.double(), g.double())
    dX = scatter(dx, iu, 8) + scatter(dy, ju, 8)
    dX64 = scatter(dx64, iu, 8) + scatter(dy64, ju, 8)
    k_err, dx_err = (k - kp).abs().max().item(), scaled_err(dX, dX64)
    fwd = dict(bound(kf.fused_flops(P, Lx, Ly, C)[0], kf.fused_bytes(P, Lx, Ly, C)))
    bwd = dict(bound(kf.fused_flops(P, Lx, Ly, C, "backward")[0],
                     kf.fused_bytes(P, Lx, Ly, C, "backward")))
    row = shape_row(
        "k4_sweep_shape", [8, 3, 7], k_err,
        event_ms(lambda: kf.fused_forward(xt, yt, residuals=True), 50),
        event_ms(lambda: kf.fused_forward_plain(xt, yt, True), 20), fwd,
        pairs=P, h=1.5, dX_scaled_err_vs_fp64=dx_err,
        dX_max_abs_err_vs_fp64=(dX - dX64).abs().max().item(),
        bwd_ms=event_ms(lambda: kf.fused_backward(xt, yt, ck, rc, g), 50),
        plain_bwd_ms=event_ms(lambda: kf.fused_backward_plain(xt, yt, g), 20),
        bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
        finite=bool(torch.isfinite(k).all() and torch.isfinite(dX).all()))
    if not (row["finite"] and k_err <= K4_TOL[0] and dx_err <= K4_TOL[1]):
        raise AssertionError(f"K4 at the sweep's shape disagrees with its twin: {row}")
    return row


def phase_k2_field_shape() -> dict:
    """K2 at the obstacle field's pathsig Gram: knots [16, 4, 2] uniform in
    [-4, 4]² (``run``'s draw) at h = 3.0, against the fp32 twin (K atol
    1e-4) and the twin in fp64 (dX scaled 4e-4, ``K2_TOL``); times, bound."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    gen = torch.Generator(device="cuda").manual_seed(41)
    X = -4.0 + 8.0 * torch.rand((16, 4, 2), generator=gen, device="cuda")
    K, dX = kb3.block3_gram_and_grad(X, 3.0)
    Kp, _ = kb3.block3_gram_and_grad_plain(X, 3.0)
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 3.0)
    k_err, dx_err = (K - Kp).abs().max().item(), scaled_err(dX, dX64)
    row = shape_row(
        "k2_field_shape", [16, 4, 2], k_err,
        event_ms(lambda: kb3.block3_gram_and_grad(X, 3.0), 50),
        event_ms(lambda: kb3.block3_gram_and_grad_plain(X, 3.0), 20),
        bound(kb3.block3_flops(16, 4, 2), kb3.block3_bytes(16, 4, 2)),
        pairs=136, h=3.0, dX_scaled_err_vs_fp64=dx_err,
        finite=bool(torch.isfinite(K).all() and torch.isfinite(dX).all()))
    if not (row["finite"] and k_err <= K2_TOL[0] and dx_err <= K2_TOL[1]):
        raise AssertionError(f"K2 at the field's shape disagrees with its twin: {row}")
    return row


def phase_k8_sweep_shape() -> dict:
    """K8's forward and backward at the full-width sweep cell's order-6
    Gram: the increments of knots [20, 3, 7] at h = 1.5 (400 pairs), against
    the bf16 twin (``K8_TOL``) and the fp32 block propagator
    (``K8_FP32_TOL``); times by CUDA events, both parts' bounds."""
    from sigsvgd_tpu_torch.kernels import mxu_chain as mc
    from sigsvgd_tpu_torch.kernels.sigkernel import solve_goursat_pde_mxu

    gen = torch.Generator(device="cuda").manual_seed(42)
    inc = knot_increments(20, gen)
    B, lx1, ly1 = inc.shape
    g = torch.randn(B, generator=gen, device="cuda")
    k, d = chunked_vjp(lambda t: mc.solve_goursat_pde_mxu_chain(t, 6), inc, g, B)
    kp, dp = chunked_vjp(lambda t: mc.solve_goursat_pde_mxu_chain_plain(t, 6), inc, g, B)
    kr, dr = chunked_vjp(lambda t: solve_goursat_pde_mxu(t, 6), inc, g, B)
    nbx, nby, sub = mc._geometry(lx1, ly1, 6)
    z = (inc / float(4 ** 6)).reshape(B, lx1 * ly1).contiguous()
    geom = (nbx, nby, sub, ly1)
    fl, flb = mc.chain_flops(B, lx1, ly1, 6), mc.chain_flops(B, lx1, ly1, 6, backward=True)
    bwd = bound(flb[1], mc.chain_bytes(B, lx1, ly1, backward=True), flb[0])
    errs = {"k_scaled_err_vs_plain": scaled_err(k, kp), "dz_scaled_err_vs_plain": scaled_err(d, dp),
            "k_scaled_err_vs_fp32": scaled_err(k, kr), "dz_scaled_err_vs_fp32": scaled_err(d, dr)}
    row = shape_row(
        "k8_sweep_shape", [B, lx1, ly1], (k - kp).abs().max().item(),
        event_ms(lambda: mc.mxu_chain_fwd(z, *geom), 50),
        event_ms(lambda: mc._plain_forward(z, *geom, 10), 10),
        bound(fl[1], mc.chain_bytes(B, lx1, ly1), fl[0]),
        knots=[20, 3, 7], dyadic_order=6, dz_max_abs_err=(d - dp).abs().max().item(), **errs,
        bwd_ms=event_ms(lambda: mc.mxu_chain_bwd(z, g, *geom), 50),
        plain_bwd_ms=event_ms(lambda: mc._plain_backward(z, g, *geom, 10), 10),
        bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
        finite=bool(torch.isfinite(k).all() and torch.isfinite(d).all()))
    if not (row["finite"] and errs["k_scaled_err_vs_plain"] <= K8_TOL[0]
            and errs["dz_scaled_err_vs_plain"] <= K8_TOL[1]
            and errs["k_scaled_err_vs_fp32"] <= K8_FP32_TOL[0]
            and errs["dz_scaled_err_vs_fp32"] <= K8_FP32_TOL[1]):
        raise AssertionError(f"K8 at the sweep's shape disagrees with its twin: {row}")
    return row


def phase_robot_planning_quick() -> dict:
    """The README's ``robot_planning --scenes pillars_4 --quick`` through
    ``run_experiment`` on the card: 2 requests × 1 seed × pathsig, svgd,
    sgd at ``QUICK_CONFIG`` (pathsig at depth 3 on knots [8, 3, 7], inside
    the block3 envelope: K2 once an iteration, no other kernel, as the JAX
    package runs its block3 kernel there). Each row, the launches of each
    cell (read around its ``run_optimisation``), every cost finite."""
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig

    cfg = PlannerConfig(**QUICK_CONFIG)
    run_opt, cells = rp.run_optimisation, []

    def counted(problem, config, generator=None):
        with Launches(zero=False) as cell:
            x, data = run_opt(problem, config, generator=generator)
        cells.append((config.method, cell.counts, data.loss))
        return x, data

    rp.run_optimisation = counted
    t0 = time.perf_counter()
    try:
        with Launches() as total, tempfile.TemporaryDirectory() as out:
            rows = rp.run_experiment(["pillars_4"], ["pathsig", "svgd", "sgd"], 1,
                                     Path(out), cfg, n_requests=2)
    finally:
        rp.run_optimisation = run_opt
    wall_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(loss).all()) for _, _, loss in cells)
    row = {"phase": "robot_planning_quick", "config": QUICK_CONFIG, "rows": rows,
           "cells": [{"method": m, "k2_launches": c["block3_gram_and_grad"],
                      "mean_cost_first": loss[0].mean().item(),
                      "mean_cost_last": loss[-1].mean().item()}
                     for m, c, loss in cells],
           "launches": total.counts, "wall_s": wall_s, "finite": finite}
    emit(row)
    n_pathsig = sum(m == "pathsig" for m, _, _ in cells)
    total.expect("robot_planning_quick", block3_gram_and_grad=n_pathsig * cfg.n_iter)
    for m, c, _ in cells:
        want = cfg.n_iter if m == "pathsig" else 0
        if c["block3_gram_and_grad"] != want:
            raise AssertionError(f"robot_planning_quick: a {m} cell launched K2 {c}")
    if len(rows) != 6 or not finite:
        raise AssertionError(f"robot_planning_quick: {len(rows)} rows, finite={finite}")
    return row


def phase_robot_planning_full() -> dict:
    """One full-width cell of the learned sweep: ``pillars_4``'s first
    request, one seed, pathsig at ``PlannerConfig()`` (20 × 500, depth 6,
    T = 200) with both models trained by ``train_scene_models`` at the JAX
    package's sizes (200,000 samples, 15 epochs): the trainings' wall s and
    first and last epoch losses (the last below the first), the models'
    accuracy and AUC against the exact oracles (``verify_learned``), the
    run's wall s, its mean cost at the start and at the end (lower), the
    audit, K8 launched once forward and once backward an iteration and no
    other kernel; then the median ms of ``FULL_TIMED_ITERS`` iterations
    after the run."""
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.experiments import verify_learned as vl
    from sigsvgd_tpu_torch.experiments.planning import (
        PlannerConfig, evaluate_trajectory, planner_sampler, run_optimisation,
    )
    from sigsvgd_tpu_torch.experiments.verify_trajectory import verify_knot_trajectories
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot
    from sigsvgd_tpu_torch.models.robot.scene import get_scene

    cfg = PlannerConfig()
    robot = PandaRobot.create(device="cuda")
    occmap, self_pred = rp.train_scene_models(robot, "pillars_4")
    trainings = {name: {"wall_s": m.train_wall_s, "epoch_loss_first": float(m.epoch_losses[0]),
                        "epoch_loss_last": float(m.epoch_losses[-1]),
                        "epochs": len(m.epoch_losses)}
                 for name, m in (("occupancy", occmap), ("self_collision", self_pred))}
    audit_models = {
        "occupancy": vl.verify_occupancy_model(occmap, get_scene("pillars_4")),
        "self_collision": vl.verify_self_collision_model(self_pred, robot)}
    req = rp.default_requests(robot, "pillars_4", n=1)[0]
    problem = rp.build_problem(robot, "pillars_4", req, True, occmap, self_pred, cfg.timesteps)
    seed = rp.generate_seeds(1)[0]
    with Launches() as run:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, data = run_optimisation(problem, cfg,
                                   generator=torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    with torch.no_grad():
        ev = evaluate_trajectory(problem, x)
    audit = verify_knot_trajectories(robot, get_scene("pillars_4"), problem.q_start,
                                     problem.q_target, x, timesteps=cfg.timesteps)
    svgd, score = planner_sampler(problem, cfg)
    state, xi, iter_ms = svgd.init(x), x, []
    for _ in range(FULL_TIMED_ITERS):
        t1 = time.perf_counter()
        xi, state = svgd.step_update(xi, state, score(xi, None))
        torch.cuda.synchronize()
        iter_ms.append((time.perf_counter() - t1) * 1e3)
    cost0, cost1 = data.loss[0].mean().item(), data.loss[-1].mean().item()
    row = {"phase": "robot_planning_full", "scene": "pillars_4", "seed": seed,
           "batch": cfg.batch, "n_iter": cfg.n_iter, "depth": cfg.depth,
           "timesteps": cfg.timesteps, "mxu_precision": cfg.mxu_precision,
           "trainings": trainings, "learned_model_audit": {
               k: {m: v[m] for m in ("accuracy", "auc", "precision", "recall",
                                     "positive_rate")} for k, v in audit_models.items()},
           "wall_s": wall_s, "ms_per_iter_run": wall_s * 1e3 / cfg.n_iter,
           "ms_per_iter_median": statistics.median(iter_ms), "ms_per_iter_samples": iter_ms,
           "mean_cost_first": cost0, "mean_cost_last": cost1,
           "success_rate": ev["success"].float().mean().item(),
           "best_ee_length": ev["ee_path_length"].min().item(),
           "audit": {"n_valid": audit["n_valid"],
                     "env_collision_fraction_mean": float(audit["env_collision_fraction"].mean()),
                     "self_collision_fraction_mean":
                         float(audit["self_collision_fraction"].mean())},
           "launches": run.counts, "finite": bool(torch.isfinite(x).all())}
    emit(row)
    run.expect("robot_planning_full", mxu_chain_fwd=cfg.n_iter, mxu_chain_bwd=cfg.n_iter)
    falling = all(t["epoch_loss_last"] < t["epoch_loss_first"] for t in trainings.values())
    if not (row["finite"] and cost1 < cost0 and falling):
        raise AssertionError(f"robot_planning_full: a cost or a loss did not fall: {row}")
    return row


def phase_obstacle_field() -> dict:
    """``obstacle_field.run(method="pathsig")`` at the JAX defaults (300
    iterations, 16 knot particles of 4 free knots; K2 once an iteration, no
    other kernel) after a 5-iteration warm-up: best and mean cost, ms an
    iteration (the run's wall over its iterations), the best cost below 1.5
    times the straight line's (``tests/test_experiments.py``)."""
    import math

    from sigsvgd_tpu_torch.experiments import obstacle_field as of

    of.run(method="pathsig", n_iter=5, device="cuda")
    with Launches() as run:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = of.run(method="pathsig", device="cuda")
        wall_s = time.perf_counter() - t0
    problem = of.FieldProblem(of.ObstacleField.create())
    straight = torch.stack([torch.linspace(problem.start[i], problem.goal[i], 100)
                            for i in range(2)], dim=-1)
    straight_cost = (problem.w_obstacle * problem.field.density(straight).sum().item()
                     + problem.w_length * 8 * math.sqrt(2))
    row = {"phase": "obstacle_field", "method": "pathsig", "n_iter": 300, "batch": 16,
           "n_free_knots": 4, "best_cost": res["best_cost"], "mean_cost": res["mean_cost"],
           "straight_line_cost": straight_cost, "wall_s": wall_s,
           "ms_per_iter": wall_s * 1e3 / 300, "launches": run.counts,
           "finite": bool(np.isfinite(res["final_costs"]).all())}
    emit(row)
    run.expect("obstacle_field", block3_gram_and_grad=300)
    if not (row["finite"] and res["best_cost"] < 1.5 * straight_cost):
        raise AssertionError(f"obstacle_field: the best path is no better: {row}")
    return row


def phase_planning_sweep_small_vs_cpu() -> list:
    """The same small work on the card and on the CPU within
    ``PLANNING_SWEEP_TOL``: ``pillars_4``'s requests (equal), a sweep cell
    (pathsig at depth 3 on knots [8, 3, 7], T = 60, 10 iterations from the
    same knots: K2 on the card, its twin on the CPU), 5 pathsig iterations
    of the obstacle field from the same knots (K2 and its twin) and a
    100-iteration IK solve of 16 targets."""
    import dataclasses as dc

    from sigsvgd_tpu_torch.experiments import obstacle_field as of
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig, run_optimisation
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

    cfg = dc.replace(PlannerConfig(**QUICK_CONFIG), n_iter=10)
    gen = torch.Generator().manual_seed(43)
    x0 = torch.rand((8, 3, 7), generator=gen)
    fx0 = -4.0 + 8.0 * torch.rand((16, 4, 2), generator=gen)
    q_true = torch.rand((16, 7), generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        robot = PandaRobot.create(device=dev)
        lower, upper = robot.joint_limits()
        reqs = rp.default_requests(robot, "pillars_4", n=2)
        problem = rp.build_problem(robot, "pillars_4", reqs[0], False, None, None,
                                   cfg.timesteps)
        with Launches() as cell:
            x, data = run_optimisation(problem, cfg, x0=lower + (upper - lower) * x0.to(dev))
        field = of.run(method="pathsig", n_iter=5, device=dev, x0=fx0.to(dev))
        targets = robot.ee_position(lower + (upper - lower) * q_true.to(dev))
        q = robot.ee_xs_to_qs(targets)
        ee_err = torch.linalg.norm(robot.ee_position(q) - targets, dim=-1).max().item()
        out[dev] = ([(r.start, r.target) for r in reqs], x.cpu(), data.loss.cpu(),
                    field["paths"], q.cpu(), ee_err, cell.counts)
    (rg, xg, lg, fg, qg, eg, cg), (rc, xc, lc, fc, qc, ec, cc) = out["cuda"], out["cpu"]
    rtol, atol = PLANNING_SWEEP_TOL["sweep_knots"]
    row = {"phase": "planning_small_vs_cpu", "tol": PLANNING_SWEEP_TOL,
           "requests_equal": rg == rc,
           "sweep_knots_abs": (xg - xc).abs().max().item(),
           "sweep_loss_rel": ((lg - lc).abs() / lc.abs()).max().item(),
           "field_paths_abs": float(np.abs(fg - fc).max()),
           "ik_q_abs": (qg - qc).abs().max().item(), "ik_ee_err": [eg, ec],
           "k2_launches": [cg["block3_gram_and_grad"], cc["block3_gram_and_grad"]]}
    emit(row)
    ok = (row["requests_equal"] and torch.allclose(xg, xc, rtol=rtol, atol=atol)
          and torch.allclose(lg, lc, rtol=rtol, atol=atol)
          and row["field_paths_abs"] <= PLANNING_SWEEP_TOL["field_paths"]
          and row["ik_q_abs"] <= PLANNING_SWEEP_TOL["ik_q"] and max(eg, ec) < 0.01
          and row["k2_launches"] == [cfg.n_iter, 0])
    if not ok:
        raise AssertionError(f"the card's planning disagrees with the CPU's: {row}")
    return row


LBFGS_ITERS = 100  # planning_lbfgs's cut of PlannerConfig()'s 500 iterations
LBFGS_RESUME_ITERS = (20, 10)  # planning_lbfgs_resume: the run, its checkpoint interval
MAZE_RESUME_STEPS = (6, 4, 2)  # maze_resume: the episode, the stop, the interval
DUST_LBFGS_STEPS = 20
DUST_LBFGS_TOL = (1e-3, 1e-4)  # rtol, atol of 3 chained card-vs-CPU L-BFGS solves
MESH_RUN_ITERS = 50
MESH_POINTS = 100_000
MESH_TOL = 1e-6  # grid_sdf's values and gradients, card against CPU


def phase_lbfgs_mesh() -> dict:
    """L-BFGS, the checkpointed runs and the mesh scene, in a fresh process
    (``chip_smoke.py --lbfgs-mesh``, :func:`lbfgs_mesh_phases`; host-bound
    paths, kept apart from this process's profiler sessions). Its rows, by
    phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--lbfgs-mesh"], capture_output=True,
                          text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            rows.setdefault(row["phase"], row)
            emit(row)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"the L-BFGS and mesh process failed (exit {proc.returncode})")
    want = {"planning_lbfgs", "planning_lbfgs_resume", "maze_resume", "dust_lbfgs",
            "mesh_scene"}
    if set(rows) != want:
        raise AssertionError(f"the L-BFGS and mesh process gave the phases {sorted(rows)}")
    emit({"phase": "lbfgs_mesh_process", "wall_s": wall_s})
    return rows


def lbfgs_mesh_phases() -> None:
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)

    phase_planning_lbfgs()
    phase_planning_lbfgs_resume()
    phase_maze_resume()
    phase_dust_lbfgs()
    phase_mesh_scene()


class _Interrupted(Exception):
    pass


def probed_problem(problem, calls: list, stop_when=None):
    """``problem`` with its cost logging each call (host time, whether
    autograd was on) into ``calls``; ``stop_when()`` true interrupts the run
    at its next cost."""
    from sigsvgd_tpu_torch.experiments.planning import PlanningProblem

    class Probed(PlanningProblem):
        def batch_cost(self, x):
            if stop_when is not None and stop_when():
                raise _Interrupted
            calls.append((time.perf_counter(), torch.is_grad_enabled()))
            return super().batch_cost(x)

    return Probed(**{f.name: getattr(problem, f.name) for f in dataclasses.fields(problem)})


def lbfgs_iterations(calls: list, t_end: float):
    """Per iteration, from the cost calls of an L-BFGS planning run (the
    score's, with autograd; the value's, without; then one a probe): its
    host ms and its line-search probes."""
    starts = [i for i, (_, g) in enumerate(calls) if g and (i + 1 < len(calls))
              and not calls[i + 1][1]]
    ms, probes = [], []
    for k, i in enumerate(starts):
        j = starts[k + 1] if k + 1 < len(starts) else len(calls)
        t_next = calls[j][0] if j < len(calls) else t_end
        ms.append((t_next - calls[i][0]) * 1e3)
        probes.append(j - i - 2)
    return ms, probes


def lbfgs_planning_problem(scene_tag: str = "pillars_4"):
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

    robot = PandaRobot.create(device="cuda")
    req = rp.default_requests(robot, scene_tag, n=1)[0]
    return rp.build_problem(robot, scene_tag, req, False, None, None, 200)


def phase_planning_lbfgs() -> dict:
    """``run_optimisation`` with ``PlannerConfig(method="pathsig",
    optimizer="lbfgs")`` at its full width (20 particles, 5 knots, depth 6,
    T = 200) on ``pillars_4``'s first default request, for ``LBFGS_ITERS``
    of its 500 iterations: ms an iteration, line-search probes an iteration
    (from the cost's calls), the mean cost at the first and the last
    iteration (lower), exactly one K8 forward and backward an iteration and
    no other kernel (the probes run the cost alone)."""
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig, run_optimisation

    cfg = PlannerConfig(method="pathsig", optimizer="lbfgs", n_iter=LBFGS_ITERS)
    calls = []
    problem = probed_problem(lbfgs_planning_problem(), calls)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with Launches() as run:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, data = run_optimisation(problem, cfg, generator=gen)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    ms, probes = lbfgs_iterations(calls, t_end)
    cost0, cost1 = data.loss[0].mean().item(), data.loss[-1].mean().item()
    row = {"phase": "planning_lbfgs", "scene": "pillars_4", "batch": cfg.batch,
           "n_iter": cfg.n_iter, "n_iter_cut_from": 500, "depth": cfg.depth,
           "timesteps": cfg.timesteps, "memory_size": 10, "max_linesearch_steps": 15,
           "wall_s": t_end - t0, "ms_per_iter_median": statistics.median(ms),
           "ms_per_iter_spread": [min(ms), max(ms)],
           "probes_per_iter_mean": float(np.mean(probes)), "probes_per_iter_max": max(probes),
           "iterations_seen": len(ms), "mean_cost_first": cost0, "mean_cost_last": cost1,
           "launches": run.counts, "finite": bool(torch.isfinite(x).all())}
    emit(row)
    run.expect("planning_lbfgs", mxu_chain_fwd=cfg.n_iter, mxu_chain_bwd=cfg.n_iter)
    if not (row["finite"] and len(ms) == cfg.n_iter and cost1 < cost0):
        raise AssertionError(f"planning_lbfgs: the mean cost did not fall: {row}")
    return row


def phase_planning_lbfgs_resume() -> dict:
    """The L-BFGS planning config at ``LBFGS_RESUME_ITERS[0]`` iterations:
    twice uninterrupted; once with checkpoints every
    ``LBFGS_RESUME_ITERS[1]`` interrupted right after its first; once
    resumed from it; then once more on the finished directory. The two
    uninterrupted runs equal each other and the resumed run bit for bit; the
    finished directory gives the same knots and an empty loss; K8 once
    forward and backward an iteration run."""
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig, run_optimisation

    n_iter, every = LBFGS_RESUME_ITERS
    cfg = PlannerConfig(method="pathsig", optimizer="lbfgs", n_iter=n_iter)
    base = lbfgs_planning_problem()
    x0 = planning_x0(base, cfg)
    runs = []
    with tempfile.TemporaryDirectory() as d:
        ck = Path(d) / "ck"
        for stage in ("uninterrupted", "again", "interrupted", "resumed", "finished"):
            calls = []
            stop = (lambda: (ck / f"step_{every}").exists()) if stage == "interrupted" else None
            problem = probed_problem(base, calls, stop)
            kw = {} if stage in ("uninterrupted", "again") else dict(
                checkpoint_dir=str(ck), checkpoint_every=every)
            t0 = time.perf_counter()
            with Launches() as counted:
                try:
                    x, data = run_optimisation(problem, cfg, x0=x0, **kw)
                except _Interrupted:
                    x = data = None
                torch.cuda.synchronize()
            runs.append((stage, x, data, counted.counts, time.perf_counter() - t0))
            steps = sorted(p.name for p in ck.iterdir()) if ck.exists() else []
            if stage == "interrupted" and steps != [f"step_{every}"]:
                raise AssertionError(f"planning_lbfgs_resume: checkpoints {steps}")
    res = {stage: (x, data, counts, wall) for stage, x, data, counts, wall in runs}
    x_full, x_again = res["uninterrupted"][0], res["again"][0]
    x_res, d_res = res["resumed"][:2]
    x_fin, d_fin = res["finished"][:2]
    deterministic = bool(torch.equal(x_full, x_again))
    row = {"phase": "planning_lbfgs_resume", "n_iter": n_iter, "checkpoint_every": every,
           "deterministic": deterministic, "resumed_bit_equal": bool(torch.equal(x_res, x_full)),
           "resumed_abs": (x_res - x_full).abs().max().item(),
           "finished_bit_equal": bool(torch.equal(x_fin, x_res)),
           "finished_loss_len": int(d_fin.loss.shape[0]),
           "resumed_loss_len": int(d_res.loss.shape[0]),
           "launches": {stage: {k: v for k, v in r[2].items() if v} for stage, r in res.items()},
           "wall_s": {stage: r[3] for stage, r in res.items()}}
    emit(row)
    k8 = {stage: (r[2]["mxu_chain_fwd"], r[2]["mxu_chain_bwd"]) for stage, r in res.items()}
    want = {"uninterrupted": (n_iter,) * 2, "again": (n_iter,) * 2,
            "interrupted": (every,) * 2, "resumed": (n_iter - every,) * 2, "finished": (0, 0)}
    others = sum(v for r in res.values() for k, v in r[2].items() if not k.startswith("mxu"))
    ok = (deterministic and row["resumed_bit_equal"] and row["finished_bit_equal"]
          and row["finished_loss_len"] == 0 and row["resumed_loss_len"] == n_iter - every
          and k8 == want and others == 0)
    if not ok:
        raise AssertionError(f"planning_lbfgs_resume: {row}")
    return row


def planning_x0(problem, cfg):
    from sigsvgd_tpu_torch.experiments.planning import uniform_knots

    return uniform_knots(problem.robot, cfg.batch, cfg.length - 2,
                         torch.Generator(device="cuda").manual_seed(1))


def phase_maze_resume() -> dict:
    """``MazeConfig()``'s width with the signature kernel and the MPF: a
    ``MAZE_RESUME_STEPS[0]``-step episode against one stopped at
    ``MAZE_RESUME_STEPS[1]`` with checkpoints every
    ``MAZE_RESUME_STEPS[2]`` steps and resumed to the end, its draws from
    the episode's CUDA generator (its state is in the checkpoint): the
    trajectories, actions and MPF particles bit-equal, K2 twice a step."""
    from sigsvgd_tpu_torch.experiments import maze

    n, stop, every = MAZE_RESUME_STEPS
    cfg = maze.MazeConfig(kernel="signature", use_mpf=True, steps=n)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for stage, c in (("full", cfg),
                         ("stopped", dataclasses.replace(cfg, steps=stop, checkpoint_dir=d,
                                                         checkpoint_every=every)),
                         ("resumed", dataclasses.replace(cfg, checkpoint_dir=d,
                                                         checkpoint_every=every))):
            t0 = time.perf_counter()
            with Launches() as counted:
                res = maze.run_episode(c, 3, device="cuda")
            out[stage] = (res, counted.counts, time.perf_counter() - t0)
    full, stopped, resumed = (out[s][0] for s in ("full", "stopped", "resumed"))
    equal = {k: bool(np.array_equal(resumed[k], full[k]))
             for k in ("trajectory", "actions", "costs", "dyn_particles")}
    row = {"phase": "maze_resume", "n_paths": cfg.n_policies + maze.N_PRIM,
           "horizon": cfg.horizon, "steps": [full["steps"], stopped["steps"],
                                             resumed["steps"]],
           "bit_equal": equal,
           "trajectory_abs": float(np.abs(resumed["trajectory"] - full["trajectory"]).max()),
           "k2_launches": {s: out[s][1]["block3_gram_and_grad"] for s in out},
           "wall_s": {s: out[s][2] for s in out}}
    emit(row)
    want = {"full": 2 * n, "stopped": 2 * stop, "resumed": 2 * (n - stop)}
    others = sum(v for s in out for k, v in out[s][1].items() if k != "block3_gram_and_grad")
    if not (all(equal.values()) and row["k2_launches"] == want and others == 0
            and row["steps"] == [n, stop, n]):
        raise AssertionError(f"maze_resume: the resumed episode differs: {row}")
    return row


def phase_dust_lbfgs() -> dict:
    """The pendulum's DuSt (policy mode, 4 policies, H = 20, 2 Stein steps a
    solve) with ``lbfgs(memory_size=4)`` and ``roll_opt_state=True``:
    ``DUST_LBFGS_STEPS`` swing-up steps, all finite, every policy-shaped
    optimizer leaf with a zero last slot after each solve; then its first 3
    steps on the card and the CPU from the same initial policies (no other
    draws) within ``DUST_LBFGS_TOL``."""
    from sigsvgd_tpu_torch.controllers.dust import DuSt
    from sigsvgd_tpu_torch.inference.svgd import lbfgs
    from sigsvgd_tpu_torch.kernels.rbf import ScaledGaussianKernel
    from sigsvgd_tpu_torch.models.pendulum import PendulumModel

    model = PendulumModel(dt=0.05)
    pol0 = -2.0 + 4.0 * torch.rand((4, 20, 1), generator=torch.Generator().manual_seed(6))

    def episode(dev, steps):
        ctrl = DuSt(model=model, hz_len=20, n_pol=4, device=dev, kernel_mode="policy",
                    kernel=ScaledGaussianKernel(), optimizer=lbfgs(memory_size=4),
                    roll_opt_state=True, inst_cost_fn=model.swingup_inst_cost,
                    term_cost_fn=model.swingup_term_cost)
        cs = ctrl.init(pol_mean=pol0.to(dev))
        state = torch.tensor([math.pi, 0.0], device=dev)
        pol_shape = (ctrl.n_total, ctrl.hz_len, ctrl.dim_a)
        states, actions, zero_tails, probes, step_ms = [state], [], True, [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            a_seq, cs, _ = ctrl.forward(state, cs, None, opt_steps=2)
            state = model.step(state[None], a_seq[0:1])[0]
            states.append(state)
            actions.append(a_seq[0])
            if dev == "cuda":
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            zero_tails &= all(bool((lf[..., -1, :] == 0).all()) for lf in leaves_of(
                cs.svgd_state.opt_state) if lf.ndim >= 3 and tuple(lf.shape[-3:]) == pol_shape)
            probes.append(int(cs.svgd_state.opt_state[2].info.num_linesearch_steps))
        return torch.stack(states).cpu(), torch.stack(actions).cpu(), zero_tails, probes, step_ms

    with Launches() as counted:
        states, actions, zero_tails, probes, step_ms = episode("cuda", DUST_LBFGS_STEPS)
    sg, ag = episode("cuda", 3)[:2]
    sc, ac = episode("cpu", 3)[:2]
    rtol, atol = DUST_LBFGS_TOL
    theta = states[:, 0].numpy()
    row = {"phase": "dust_lbfgs", "steps": DUST_LBFGS_STEPS, "n_pol": 4, "horizon": 20,
           "memory_size": 4, "finite": bool(torch.isfinite(states).all()
                                           and torch.isfinite(actions).all()),
           "rolled_tails_zero": zero_tails, "last_solve_probes": probes,
           "ms_per_step_median": statistics.median(step_ms),
           "upright_err_min": float(np.abs((theta + np.pi) % (2 * np.pi) - np.pi).min()),
           "vs_cpu_state_abs": (sg - sc).abs().max().item(),
           "vs_cpu_action_abs": (ag - ac).abs().max().item(), "tol": list(DUST_LBFGS_TOL),
           "launches": counted.counts}
    emit(row)
    counted.expect("dust_lbfgs")
    if not (row["finite"] and zero_tails and torch.allclose(sg, sc, rtol=rtol, atol=atol)
            and torch.allclose(ag, ac, rtol=rtol, atol=atol)):
        raise AssertionError(f"dust_lbfgs: {row}")
    return row


def leaves_of(tree) -> list:
    if isinstance(tree, tuple):
        return [lf for node in tree for lf in leaves_of(node)]
    return [tree]


def phase_mesh_scene() -> dict:
    """``pillars_4`` with a closed box mesh (``write_stl(box_mesh(...))``)
    at resolution 48: the native library's build and the host's grid build
    timed; ``grid_sdf`` on the card against the CPU at ``MESH_POINTS``
    points across the workspace (values and gradients within
    ``MESH_TOL``); a ``MESH_RUN_ITERS``-iteration raw-lr pathsig run in the
    scene through ``run_optimisation`` (the cost falls; K8 once forward and
    backward an iteration); ``PandaMeshVerifier.audit_trajectory`` on the
    best particle's T = 200 trajectory, timed."""
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.experiments.planning import (
        PlannerConfig, PlanningProblem, run_optimisation, sdf_occupancy,
    )
    from sigsvgd_tpu_torch.experiments.verify_mesh import PandaMeshVerifier
    from sigsvgd_tpu_torch.models.robot import mesh_scene as ms
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot
    from sigsvgd_tpu_torch.models.robot.scene import get_scene
    from sigsvgd_tpu_torch.native import collision
    from sigsvgd_tpu_torch.utils.splines import spline_trajectory

    t0 = time.perf_counter()
    lib = collision.build_native_library()
    lib_s = time.perf_counter() - t0
    robot = PandaRobot.create(device="cuda")
    with tempfile.TemporaryDirectory() as d:
        stl = Path(d) / "box.stl"
        ms.write_stl(stl, ms.box_mesh((0.2, 0.3, 0.25)))
        obstacle = ms.MeshObstacle(str(stl), position=(0.45, -0.2, 0.9), resolution=48)
        scene = dataclasses.replace(get_scene("pillars_4", device="cuda"), meshes=(obstacle,))
        t0 = time.perf_counter()
        grid = ms.mesh_sdf_grid(obstacle, scene.workspace_low, scene.workspace_high)
        grid_ms = (time.perf_counter() - t0) * 1e3

        low = torch.tensor(scene.workspace_low)
        high = torch.tensor(scene.workspace_high)
        pts = low + (high - low) * torch.rand((MESH_POINTS, 3),
                                              generator=torch.Generator().manual_seed(8))
        res = []
        for dev in ("cuda", "cpu"):
            x = pts.to(dev).requires_grad_(True)
            v = ms.grid_sdf(grid, x)
            (g,) = torch.autograd.grad(v.sum(), x)
            res.append((v.detach().cpu(), g.cpu()))
        x = pts.cuda()
        lookup_ms = event_ms(lambda: ms.grid_sdf(grid, x), 20)

        req = rp.default_requests(robot, "pillars_4", n=1)[0]
        problem = PlanningProblem(
            robot=robot, q_start=torch.tensor(req.start, device="cuda"),
            q_target=torch.tensor(req.target, device="cuda"),
            occupancy_fn=sdf_occupancy(scene), timesteps=200)
        cfg = PlannerConfig(n_iter=MESH_RUN_ITERS)
        with Launches() as run:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            knots, data = run_optimisation(problem, cfg,
                                           generator=torch.Generator(device="cuda").manual_seed(2))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        best = int(torch.argmin(problem.batch_cost(knots)[0]))
        full = torch.cat([problem.q_start[None], knots[best], problem.q_target[None]])
        qs = spline_trajectory(full, cfg.timesteps).cpu().numpy()
        t0 = time.perf_counter()
        verifier = PandaMeshVerifier(robot)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        audit = verifier.audit_trajectory(qs, scene)
        audit_s = time.perf_counter() - t0
    (vg, gg), (vc, gc) = res
    cost0, cost1 = data.loss[0].mean().item(), data.loss[-1].mean().item()
    row = {"phase": "mesh_scene", "resolution": 48, "grid_shape": list(grid.values.shape),
           "native_library": lib.name, "native_build_s": lib_s, "grid_build_ms": grid_ms,
           "interior_cells": int((grid.values < -obstacle.margin).sum()),
           "points": MESH_POINTS, "value_abs": (vg - vc).abs().max().item(),
           "grad_abs": (gg - gc).abs().max().item(), "tol": MESH_TOL,
           "lookup_ms": lookup_ms, "run_n_iter": cfg.n_iter, "run_wall_s": run_s,
           "ms_per_iter": run_s * 1e3 / cfg.n_iter,
           "mean_cost_first": cost0, "mean_cost_last": cost1, "launches": run.counts,
           "audit_waypoints": len(qs), "verifier_setup_s": setup_s, "audit_s": audit_s,
           "audit_fraction_colliding": audit["fraction_colliding"],
           "audit_collision_free": audit["collision_free"]}
    emit(row)
    run.expect("mesh_scene", mxu_chain_fwd=cfg.n_iter, mxu_chain_bwd=cfg.n_iter)
    ok = (row["value_abs"] <= MESH_TOL and row["grad_abs"] <= MESH_TOL and cost1 < cost0
          and row["interior_cells"] > 0 and bool(torch.isfinite(knots).all()))
    if not ok:
        raise AssertionError(f"mesh_scene: {row}")
    return row


def phase_k9(timing: dict):
    """K9 against its plain twin (the matmul form on cuBLAS, which is also
    the library yardstick): at the policy solve's shape and wider D, with
    scores of unit size and 100 times larger, a ragged N, the envelope's
    small edges, row chunks ([12000, 7]) and column chunks (a 64 KiB cap);
    φ bit for bit across two calls; at each [1024, D] the times from
    ``timing`` (:func:`phase_k9_timing`) and both bounds."""
    from sigsvgd_tpu_torch.kernels import svgd_velocity as kv

    gen = torch.Generator(device="cuda").manual_seed(9)
    rtol, atol = K9_TOL
    cap0 = kv.CHUNK_BYTES
    rows = {}
    for N, D, scale, cap in ((1024, 280, 1.0, cap0), (333, 280, 1.0, cap0),
                             (1024, 840, 1.0, cap0), (1024, 1400, 1.0, cap0),
                             (1024, 280, 100.0, cap0), (1024, 840, 100.0, cap0),
                             (1024, 1400, 100.0, cap0), (1, 1, 1.0, cap0), (1, 280, 1.0, cap0),
                             (77, 1025, 1.0, cap0), (12000, 7, 1.0, cap0),
                             (300, 37, 1.0, 64 << 10)):
        x, s, h = k9_inputs(gen, N, D, scale)
        kv.CHUNK_BYTES = cap
        try:
            plan = kv.velocity_plan(N, D)
            phi = kv.fused_rbf_velocity(x, s, h)
            again = kv.fused_rbf_velocity(x, s, h)
        finally:
            kv.CHUNK_BYTES = cap0
        want = kv.rbf_velocity_plain(x, s, h)
        torch.cuda.synchronize()
        err = (phi - want).abs()
        excess = (err - (atol + rtol * want.abs())).max().item()
        finite = bool(torch.isfinite(phi).all())
        row = {"phase": "k9_vs_plain", "shape": [N, D], "score_scale": scale, "h": h.item(),
               "chunk_cap_bytes": cap, "plan": plan._asdict(),
               "planned_kernels_a_call": 2 * plan.row_chunks * plan.col_chunks,
               "max_abs_err": err.max().item(),
               "max_excess_over_tolerance": excess, "finite": finite,
               "bitwise_repeat": bool(torch.equal(phi, again))}
        if (N, D) == (12000, 7) and plan.row_chunks != 19:
            raise AssertionError(f"[12000, 7] planned as {plan}, not 19 row chunks")
        if cap != cap0 and plan.col_chunks < 2:
            raise AssertionError(f"the small cap planned no column chunks: {plan}")
        if scale == 1.0 and (N, D) in K9_TIMED:
            row.update({k: v for k, v in timing[(N, D)].items() if k not in ("phase", "shape")})
            row.update(plain_ms=row["library_ms"],
                       library_call="the twin: pw_dist_sq, exp, two cuBLAS fp32 matmuls",
                       **k9_bound(N, D))
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["fp32_bound_share"] = row["fp32_bound_ms"] / row["kernel_ms"]
            rows[(N, D)] = row
        emit(row)
        if not (finite and excess <= 0.0 and row["bitwise_repeat"]):
            raise AssertionError(f"K9 disagrees with its plain twin or itself: {row}")
    flagship = dict(rows[K9_TIMED[0]])
    flagship["by_shape"] = {
        f"{n}x{d}": {k: r[k] for k in ("kernel_ms", "library_ms", "kernel_graph_ms",
                                        "library_graph_ms", "bound_ms", "fp32_bound_ms")}
        for (n, d), r in rows.items()}
    return flagship


def velocity_stage(ctrl, state, pol0) -> dict:
    from sigsvgd_tpu_torch.inference.svgd import ScoreResult

    sampler = ctrl._sampler()
    score = ScoreResult(grad_log_p=torch.zeros_like(pol0))
    return {"svgd_velocity": host_ms(lambda: sampler.velocity(pol0, score, 0), 3)}


def phase_policy():
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, kernel_mode="policy",
                         fused_velocity=True)
    row = drive_solves("policy_solve", prob, {"fused_rbf_velocity": OPT_STEPS},
                       N_SOLVES, velocity_stage)
    return row["launches"]["fused_rbf_velocity"]


def trajectory_stage(ctrl, state, pol0) -> dict:
    """The trajectory kernel terms: a rollout with autograd, the kernel on
    each coordinate of τ with the ``bw_median_diff`` bandwidth, and the
    gradient of its sum in the policies."""
    return {"trajectory_kernel_terms": host_ms(lambda: ctrl._kernel_terms(pol0, state), 3)}


def phase_trajectory():
    """``kernel_mode="trajectory"`` with DuSt's default ``GaussianKernel``
    at the flagship's width: no hand kernel launches."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, kernel_mode="trajectory")
    return drive_solves("trajectory_solve", prob, {}, N_SOLVES,
                        trajectory_stage)


def scaled_velocity_stage(ctrl, state, pol0) -> dict:
    """One scaled-sampler velocity on a unit-scale score: the D = 280
    Gauss-Newton metric, the scaled kernel and, for MatrixSVGD, the solve
    by the metric."""
    from sigsvgd_tpu_torch.inference.svgd import ScoreResult

    sampler = ctrl._sampler()
    g = torch.Generator(device="cuda").manual_seed(6)
    score = ScoreResult(grad_log_p=torch.randn(pol0.shape, generator=g, device="cuda"))
    return {"scaled_velocity": host_ms(lambda: sampler.velocity(pol0, score, 0), 3)}


def phase_scaled(sampler: str):
    """Policy mode with ``stein_sampler`` "ScaledSVGD" or "MatrixSVGD" and a
    ``ScaledGaussianKernel``: the metric is 280 × 280 (H·a = 40·7)."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.kernels.rbf import ScaledGaussianKernel

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, kernel_mode="policy",
                         stein_sampler=sampler, kernel=ScaledGaussianKernel())
    phase = {"ScaledSVGD": "scaled_solve", "MatrixSVGD": "matrix_solve"}[sampler]
    row = drive_solves(phase, prob, {}, N_SOLVES, scaled_velocity_stage)
    row["metric_dim"] = prob.ctrl.hz_len * prob.ctrl.dim_a
    return row


def default_sig_stage(ctrl, state, pol0) -> dict:
    with torch.no_grad():
        _c, trs = ctrl._rollout_costs(state, pol0)
        tau = ctrl._tau(trs).contiguous()
    return {"sig_gram_adjoint": host_ms(lambda: ctrl.sig_kernel.gram_and_grad(tau), 1)}


def phase_default_sig():
    """The JAX ``DuSt``'s default signature kernel, ``SignatureKernel(
    dyadic_order=2)`` (the median bandwidth), uncalibrated at the flagship's
    width: ``gram_and_grad`` takes the wavefront's pair list (no hand
    kernel). Then one ``gram_and_grad`` on τ with its chunk count and peak
    memory, and K of 64 pairs (8 × 8 paths) against the fp64 CPU
    ``solve_goursat_pde_scan`` of the same increments, scaled by the batch
    max to atol 1e-3 (``tests/test_sigkernel.py``'s tolerance for the
    wavefront's fp32 rounding)."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.kernels.sigkernel import solve_goursat_pde_scan
    from sigsvgd_tpu_torch.kernels.sigkernel_tiled import pair_increments

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, dyadic_order=2,
                         bandwidth=None, calibrate=False)
    ctrl, kern = prob.ctrl, prob.ctrl.sig_kernel
    if kern._solver_kind(39, 39) != "wavefront":
        raise AssertionError("order 2 does not take the wavefront")
    row = drive_solves("default_sig_solve", prob, {}, DEFAULT_SIG_SOLVES,
                       default_sig_stage)
    cs = ctrl.init(generator=torch.Generator(device="cuda").manual_seed(13))
    with torch.no_grad():
        tau = ctrl._tau(ctrl._rollout_costs(prob.q_start, cs.pol_mean)[1]).contiguous()
    n = tau.shape[0]
    h = kern._subsampled_bandwidth(tau, tau)
    kind, chunk, n_chunks = kern._chunk_plan(39, 39, n * (n + 1) // 2, 2, tau.device, h)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    K, dX = kern.gram_and_grad(tau)
    torch.cuda.synchronize()
    gg_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    # 64 pairs: the pair list's increments in fp32 on the card (scaled by
    # 4^-2, pair-minor), solved in fp64 on the CPU
    ix = torch.arange(8, device="cuda").repeat_interleave(8)
    iy = torch.arange(8, device="cuda").repeat(8)
    z = pair_increments(tau, tau, ix, iy, h, 2)
    want = solve_goursat_pde_scan(z.permute(2, 0, 1).double().cpu() * 16.0, 2)
    got = K[ix, iy].double().cpu()
    k_err = ((got - want).abs().max() / want.abs().max()).item()
    out = {"phase": "default_sig_solve", "part": "gram_and_grad", "kind": kind,
           "pairs": n * (n + 1) // 2, "chunk": chunk, "chunks": n_chunks,
           "ms": gg_ms, "peak_mib": peak_mib, "k_vs_fp64_scaled_64_pairs": k_err,
           "k_range_64_pairs": [want.min().item(), want.max().item()],
           "finite": bool(torch.isfinite(K).all() and torch.isfinite(dX).all()),
           "n_solves": DEFAULT_SIG_SOLVES}
    emit(out)
    if not (out["finite"] and k_err <= 1e-3):
        raise AssertionError(f"default_sig_solve: {out}")
    return row


def traced_solve(ctrl, state, cs, generator=None) -> dict:
    """One more solve under ``torch.profiler``."""
    return traced(lambda: ctrl.forward(state, cs, generator=generator,
                                       opt_steps=OPT_STEPS))


def traced(fn) -> dict:
    """``fn`` once under ``torch.profiler``: device busy time summed over
    kernels, the traced wall time and idle share, kernel launches, and the
    kernels that take the most device time. Device activity only: recording
    the host's operators too slows the traced run and makes ``key_averages``
    take ~110 s on an H100 host for the order-2 solve's 99,500 launches
    (~28 s without), for the same busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernel")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top[:6]]}


def phase_small_vs_cpu():
    """A small problem's first SVGD score on the card against the same score
    on the CPU, where the twins replace the kernels: costs, and K and the
    kernel gradient (signature modes) or the Stein velocity (policy mode,
    K9 on the card)."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    cases = {
        "lambda0": (dict(dyadic_order=0), 3e-5, 5e-5),
        "lambda3": (dict(dyadic_order=3, calibrate=False), *K2_TOL),
        "lambda3_bf16": (dict(dyadic_order=3, calibrate=False, grad_precision="bf16"),
                         *BF16_SOLVE_TOL),
        "lambda3_linear": (dict(dyadic_order=3, calibrate=False, static="linear"), *K2_TOL),
        "policy": (dict(kernel_mode="policy", fused_velocity=True), None, 1e-4),
    }
    for name, (kw, k_tol, g_tol) in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            prob = build_arm_mpc(device=dev, n_pol=16, hz_len=8, **kw)
            pol = (torch.rand((16, 8, 7), generator=torch.Generator().manual_seed(2))
                   * 4.0 - 2.0).to(dev)
            cs = prob.ctrl.init(pol_mean=pol)
            prior = ParticleGMM(pol.reshape(16, -1), prob.ctrl._prior_var(),
                                cs.prior_weights)
            score, _tr = prob.ctrl._score(pol, prob.q_start, prior)
            if k_tol is None:
                phi, _ = prob.ctrl._sampler().velocity(pol, score, 0)
                got = (score.aux["costs"], None, phi)
            else:
                got = (score.aux["costs"], score.k_xx, score.grad_k)
            out[dev] = [None if t is None else t.detach().cpu() for t in got]
        (c0, k0, g0), (c1, k1, g1) = out["cuda"], out["cpu"]
        errs = {"costs_rel": ((c0 - c1).abs().max() / c1.abs().max()).item(),
                "grad_scaled": ((g0 - g1).abs().max() / g1.abs().max()).item()}
        if k_tol is not None:
            errs["k_abs"] = (k0 - k1).abs().max().item()
        emit({"phase": "small_solve_cuda_vs_cpu", "case": name,
              "compared": "costs, K, grad_k" if k_tol else "costs, velocity",
              **errs})
        if not (errs["costs_rel"] <= 1e-5 and errs["grad_scaled"] <= g_tol
                and (k_tol is None or errs["k_abs"] <= k_tol)):
            raise AssertionError(f"card and CPU solves disagree ({name}): {errs}")


def small_grams_vs_cpu():
    """λ=0 Grams on the card against the CPU, where the twins replace the
    kernels: the dense ``gram`` with its gradient (the wavefront on both
    devices), ``gram_sym`` on the block route (K3 on the card; values only)
    and on the pair list (K7 on the card; L·C > 128) with its gradient; K to
    rtol 3e-5 / atol 2e-5 (K reaches 23 on the 8-channel paths, where the
    fp32 twin itself is 5.6e-5 from fp64), the gradient scaled 5e-5."""
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    kern = SignatureKernel(0, bandwidth=None)
    gen = torch.Generator().manual_seed(5)
    X, Y = (torch.cumsum((torch.rand(s, generator=gen) - 0.5) * 0.4, dim=1)
            for s in ((16, 9, 2), (7, 9, 2)))
    Z = torch.cumsum((torch.rand((12, 17, 8), generator=gen) - 0.5) * 0.4, dim=1)
    for name, fn, A, grad in (("lambda0_gram", lambda a: kern.gram(a, Y.to(a.device)), X, True),
                              ("lambda0_gram_sym_block", kern.gram_sym, X, False),
                              ("lambda0_gram_sym_pairs", kern.gram_sym, Z, True)):
        out = {}
        for dev in ("cuda", "cpu"):
            a = A.to(dev, copy=True).requires_grad_(grad)
            K = fn(a)
            dA = torch.autograd.grad(K.sum(), a)[0] if grad else torch.zeros(1)
            out[dev] = (K.detach().cpu(), dA.cpu())
        (k0, g0), (k1, g1) = out["cuda"], out["cpu"]
        errs = {"k_abs": (k0 - k1).abs().max().item(),
                "k_rel": ((k0 - k1).abs() / k1.abs()).max().item(),
                "k_range": [k1.min().item(), k1.max().item()]}
        k_ok = bool(((k0 - k1).abs() <= K7_VALUE_TOL[1] + K7_VALUE_TOL[0] * k1.abs()).all())
        if grad:
            errs["grad_scaled"] = ((g0 - g1).abs().max() / g1.abs().max()).item()
        emit({"phase": "small_solve_cuda_vs_cpu", "case": name, "shape": list(A.shape),
              "compared": "K, dK/dX" if grad else "K", **errs})
        if not (k_ok and errs.get("grad_scaled", 0.0) <= K7_TOL[1]):
            raise AssertionError(f"card and CPU Grams disagree ({name}): {errs}")


def phase_trajectory_small_vs_cpu():
    """A small controller (16 policies, H = 8) in the trajectory mode (with
    the autograd likelihood, and with 4 given action samples and a
    ``ScaledGaussianKernel``) and with the ScaledSVGD and MatrixSVGD
    samplers in policy mode, on the card and the CPU from the same policies
    and draws: the first step's costs rtol 1e-5, the trajectory K rtol 1e-5
    / atol 1e-6 and its gradient scaled 1e-4 (the CPU tests' K and dK
    tolerances), φ scaled 1e-4, and over a 2-step solve the weights' argmax
    and finite policies."""
    from sigsvgd_tpu_torch.controllers.dust import DuStDraws
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.kernels.rbf import ScaledGaussianKernel
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    n, H, S = 16, 8, 4
    gen = torch.Generator().manual_seed(17)
    pol = torch.rand((n, H, 7), generator=gen) * 4.0 - 2.0
    eps = torch.randn((OPT_STEPS, S, n, H, 7), generator=gen)
    cases = {
        "trajectory": (dict(kernel_mode="trajectory"), 0),
        "trajectory_mc_scaled": (dict(kernel_mode="trajectory",
                                      kernel=ScaledGaussianKernel()), S),
        "scaled_policy": (dict(kernel_mode="policy", stein_sampler="ScaledSVGD",
                               kernel=ScaledGaussianKernel()), 0),
        "matrix_policy": (dict(kernel_mode="policy", stein_sampler="MatrixSVGD",
                               kernel=ScaledGaussianKernel()), 0),
    }
    for name, (kw, samples) in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            prob = build_arm_mpc(device=dev, n_pol=n, hz_len=H, **kw)
            ctrl = dataclasses.replace(prob.ctrl, n_action_samples=samples)
            cs = ctrl.init(pol_mean=pol.to(dev))
            prior = ParticleGMM(cs.pol_mean.reshape(n, -1), ctrl._prior_var(),
                                cs.prior_weights)
            score, _ = ctrl._score(cs.pol_mean, prob.q_start, prior, None,
                                   eps[0].to(dev) if samples else None)
            phi, _ = ctrl._sampler().velocity(cs.pol_mean, score, 0)
            draws = DuStDraws(actions=eps.to(dev)) if samples else DuStDraws()
            _a, cs2, data = ctrl.forward(prob.q_start, cs, opt_steps=OPT_STEPS, draws=draws)
            out[dev] = {"costs": score.aux["costs"].cpu(), "phi": phi.cpu(),
                        "k": None if score.k_xx is None else score.k_xx.cpu(),
                        "grad_k": None if score.grad_k is None else score.grad_k.cpu(),
                        "i_star": int(torch.argmax(data.pol_weights)),
                        "finite": bool(torch.isfinite(cs2.pol_mean).all())}
        g, c = out["cuda"], out["cpu"]
        errs = {"costs_rel": ((g["costs"] - c["costs"]).abs().max()
                              / c["costs"].abs().max()).item(),
                "phi_scaled": scaled_err(g["phi"], c["phi"]),
                "i_star": [g["i_star"], c["i_star"]]}
        ok = (errs["costs_rel"] <= 1e-5 and errs["phi_scaled"] <= 1e-4
              and g["i_star"] == c["i_star"] and g["finite"] and c["finite"])
        if c["k"] is not None:
            errs["k_excess"] = k_excess(g["k"], c["k"], 1e-5)
            errs["grad_k_scaled"] = scaled_err(g["grad_k"], c["grad_k"])
            ok &= errs["k_excess"] <= 0.0 and errs["grad_k_scaled"] <= 1e-4
        emit({"phase": "trajectory_small_vs_cpu", "case": name, "n_pol": n, "hz_len": H,
              "n_action_samples": samples, **errs})
        if not ok:
            raise AssertionError(f"card and CPU solves disagree ({name}): {errs}")


def phase_wavefront_small_vs_cpu():
    """``gram_and_grad`` by the wavefront on the card and the CPU with the
    same paths: λ=2 (the median bandwidth) at [16, 40, 2], λ=0 with linear
    statics at [24, 41, 4], and λ=1 at [16, 21, 9] through a dense ``gram``
    with its gradient; no hand kernel launched. The gradient is held
    scaled at 5e-5 (``tests/test_torch_wavefront.py``), K at rtol 1e-4 /
    atol 1e-4 (the λ=3 K atol of ``tests/test_pallas_block3.py``): on
    40-node paths each device's fp32 K is ~2.5e-4 relative from fp64 (the
    static Gram's double differences cancel), as in the JAX package, and
    the two devices' exp round apart; both distances from fp64 are
    reported."""
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    gen = torch.Generator().manual_seed(19)

    def paths(shape, step):
        return torch.cumsum((torch.rand(shape, generator=gen) - 0.5) * step, dim=1)

    cases = {
        "lambda2_gram_and_grad": (SignatureKernel(2), paths((16, 40, 2), 0.2), "gg"),
        "lambda0_linear_gram_and_grad": (SignatureKernel(0, static="linear"),
                                         paths((24, 41, 4), 0.1), "gg"),
        "lambda1_dense_gram": (SignatureKernel(1, 1.5), paths((16, 21, 9), 0.3), "gram"),
    }
    for name, (kern, X, how) in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            x = X.to(dev)
            with Launches() as counted:
                if how == "gg":
                    K, dX = kern.gram_and_grad(x)
                else:
                    xx = x.clone().requires_grad_(True)
                    K = kern.gram(xx, x[:5])
                    (dX,) = torch.autograd.grad(K.sum(), xx)
            out[dev] = (K.detach().cpu(), dX.cpu(), sum(counted.counts.values()))
        (k0, g0, n0), (k1, g1, _n1) = out["cuda"], out["cpu"]
        if how == "gg":
            k64 = kern.gram_and_grad(X.double())[0]
        else:
            k64 = kern.gram(X.double(), X[:5].double())
        errs = {"k_excess": k_excess(k0, k1, 1e-4, 1e-4), "grad_scaled": scaled_err(g0, g1),
                "k_rel_vs_fp64": [((k.double() - k64).abs() / k64.abs()).max().item()
                                  for k in (k0, k1)],
                "k_range": [k1.min().item(), k1.max().item()], "kernel_launches": n0}
        emit({"phase": "wavefront_small_vs_cpu", "case": name, "shape": list(X.shape),
              **errs})
        if not (errs["k_excess"] <= 0.0 and errs["grad_scaled"] <= 5e-5 and n0 == 0):
            raise AssertionError(f"card and CPU wavefronts disagree ({name}): {errs}")


def knot_increments(n: int, gen: torch.Generator) -> torch.Tensor:
    """The order-6 Gram's increments ``[n², 2, 2]`` of ``n`` planning knot
    paths ``[n, 3, 7]`` drawn as ``run_optimisation`` draws them (uniform in
    the Panda's joint limits), at bench's bandwidth h = 1.5."""
    from sigsvgd_tpu_torch.kernels.sigkernel import _pair_sq_dists, gram_increments

    X = uniform_knots(n, gen)
    inc = gram_increments(torch.exp(-_pair_sq_dists(X, X) / 1.5))
    return inc.reshape(n * n, 2, 2).contiguous()


def chunked_vjp(fn, inc: torch.Tensor, g: torch.Tensor, chunk: int):
    """``(k, ∂(g·k)/∂inc)`` of ``fn`` taken ``chunk`` pairs at a time."""
    ks, ds = [], []
    for c0 in range(0, inc.shape[0], chunk):
        t = inc[c0:c0 + chunk].clone().requires_grad_(True)
        k = fn(t)
        (d,) = torch.autograd.grad(k, t, g[c0:c0 + chunk])
        ks.append(k.detach())
        ds.append(d)
    return torch.cat(ks), torch.cat(ds)


def phase_k8():
    """K8's forward and backward against the bf16 twin and the fp32 block
    propagator at three shapes, each with its launch plan (``chain_plan``:
    warpgroups, ring stages, shared memory, scratch, the basis bytes read
    through L2); at the planning shape k and dz bit for bit across two
    calls, times, bound and first-launch memory."""
    from sigsvgd_tpu_torch.kernels import mxu_chain as mc
    from sigsvgd_tpu_torch.kernels.sigkernel import solve_goursat_pde_mxu

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the fp32 reference would not be fp32")
    gen = torch.Generator(device="cuda").manual_seed(8)
    chunk = 131072
    rows = {}
    first = True
    for name, lam in (("planning", 6), ("ragged_16_hops", 6), ("sub2", 7)):
        if name == "planning":
            inc = knot_increments(1024, gen)
        elif name == "ragged_16_hops":
            inc = torch.randn((389, 4, 4), generator=gen, device="cuda").clamp(-2, 2)
        else:
            inc = torch.randn((1000, 2, 2), generator=gen, device="cuda").clamp(-2, 2)
        B, lx1, ly1 = inc.shape
        g = torch.randn(B, generator=gen, device="cuda")
        out = []

        def kernel_vjp():
            t = inc.clone().requires_grad_(True)
            k = mc.solve_goursat_pde_mxu_chain(t, lam)
            out.extend([k.detach(), torch.autograd.grad(k, t, g)[0]])

        mib = device_mib_outside_allocator(kernel_vjp)
        k, d = out
        kp, dp = chunked_vjp(lambda t: mc.solve_goursat_pde_mxu_chain_plain(t, lam),
                             inc, g, chunk)
        kr, dr = chunked_vjp(lambda t: solve_goursat_pde_mxu(t, lam), inc, g, chunk)
        torch.cuda.synchronize()

        def scaled(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()

        finite = bool(torch.isfinite(k).all() and torch.isfinite(d).all())
        row = {"phase": "k8_vs_plain", "shape": [B, lx1, ly1], "dyadic_order": lam,
               "k_scaled_err_vs_plain": scaled(k, kp), "dz_scaled_err_vs_plain": scaled(d, dp),
               "k_max_abs_err": (k - kp).abs().max().item(),
               "dz_max_abs_err": (d - dp).abs().max().item(),
               "k_scaled_err_vs_fp32": scaled(k, kr), "dz_scaled_err_vs_fp32": scaled(d, dr),
               "plain_k_scaled_err_vs_fp32": scaled(kp, kr),
               "k_range": [k.min().item(), k.max().item()], "finite": finite}
        if first:
            row["first_launch_mib_outside_allocator"] = mib
            first = False
        nbx, nby, sub = mc._geometry(lx1, ly1, lam)
        row["plan"] = {which: mc.device_plan(B, lx1 * ly1, nbx, nby, 10, bwd, "cuda").__dict__
                       for which, bwd in (("forward", False), ("backward", True))}
        if name == "planning":
            z = (inc / float(4 ** lam)).reshape(B, lx1 * ly1).contiguous()
            geom = (nbx, nby, sub, ly1)
            k2, d2 = mc.mxu_chain_fwd(z, *geom), mc.mxu_chain_bwd(z, g, *geom)
            row["bitwise_repeatable"] = bool(torch.equal(k2, mc.mxu_chain_fwd(z, *geom))
                                             and torch.equal(d2, mc.mxu_chain_bwd(z, g, *geom)))
            del k2, d2
            row["fwd_ms"] = event_ms(lambda: mc.mxu_chain_fwd(z, *geom), 5)
            row["bwd_ms"] = event_ms(lambda: mc.mxu_chain_bwd(z, g, *geom), 3)

            def twin_fwd():
                for c0 in range(0, B, chunk):
                    mc._plain_forward(z[c0:c0 + chunk], *geom, 10)

            def twin_bwd():
                for c0 in range(0, B, chunk):
                    mc._plain_backward(z[c0:c0 + chunk], g[c0:c0 + chunk], *geom, 10)

            row["plain_fwd_ms"] = event_ms(twin_fwd, 1)
            row["plain_bwd_ms"] = event_ms(twin_bwd, 1)
            row["fp32_route_fwd_bwd_ms"] = event_ms(lambda: chunked_vjp(
                lambda t: solve_goursat_pde_mxu(t, lam), inc, g, chunk), 1)
            row["fwd_bound"] = bound(mc.chain_flops(B, lx1, ly1, lam)[1],
                                     mc.chain_bytes(B, lx1, ly1),
                                     mc.chain_flops(B, lx1, ly1, lam)[0])
            row["bwd_bound"] = bound(mc.chain_flops(B, lx1, ly1, lam, backward=True)[1],
                                     mc.chain_bytes(B, lx1, ly1, backward=True),
                                     mc.chain_flops(B, lx1, ly1, lam, backward=True)[0])
            rows["planning"] = row
        emit(row)
        ok = (finite and row["k_scaled_err_vs_plain"] <= K8_TOL[0]
              and row["dz_scaled_err_vs_plain"] <= K8_TOL[1]
              and row["k_scaled_err_vs_fp32"] <= K8_FP32_TOL[0]
              and row["dz_scaled_err_vs_fp32"] <= K8_FP32_TOL[1]
              and row.get("bitwise_repeatable", True))
        if not ok:
            raise AssertionError(f"K8 disagrees with its twin or the fp32 route: {row}")
    return rows["planning"]


def planning_setup(batch: int, timesteps: int = 200, precision: str = "default",
                   device: str = "cuda", depth: int = 6):
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_planning_problem
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig, planner_sampler

    problem = build_planning_problem(device=device, timesteps=timesteps)
    cfg = PlannerConfig(batch=batch, timesteps=timesteps, mxu_precision=precision,
                        depth=depth)
    svgd, score = planner_sampler(problem, cfg)
    return problem, cfg, svgd, score


# the kernel launches of one planning iteration at 1024 knots, by depth: K8's
# hop chain at bench's depth 6, K2 at 3 and K1 at 0 (the block kernels the
# JAX package runs on [1024, 3, 7] knots)
PLANNING_ITER_KERNELS = {6: {"mxu_chain_fwd": 1, "mxu_chain_bwd": 1},
                         3: {"block3_gram_and_grad": 1}, 0: {"block_gram_and_grad": 1}}
PLANNING_ITERS = (3, 5)  # warm-up, timed


def phase_planning_iter(depth: int = 6) -> dict:
    """The planner at ``run_optimisation``'s full width (1024 knot particles
    [1024, 3, 7], ``bookshelf_small``, T = 200) at dyadic order ``depth``:
    3 warm-up and 5 timed chained SVGD iterations with every kernel's
    counters read around them (``PLANNING_ITER_KERNELS``: one launch of each
    an iteration, no other kernel), the stage split, one traced iteration,
    and the mean cost, which must fall from the first knots to the last.
    ``planning_iter`` at bench's depth 6, ``planning_iter_depth3`` and
    ``planning_iter_depth0`` at the orders the README's ``--quick`` sweep
    and a calibrated planner run. Returns the timed window's launches."""
    from sigsvgd_tpu_torch.inference.score import _grad_neg_cost
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    name = "planning_iter" if depth == 6 else f"planning_iter_depth{depth}"
    warm, timed = PLANNING_ITERS
    t0 = time.perf_counter()
    problem, cfg, svgd, score = planning_setup(1024, depth=depth)
    lower, upper = problem.robot.joint_limits()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = lower + (upper - lower) * torch.rand((cfg.batch, cfg.length - 2, 7),
                                             generator=gen, device="cuda")
    state = svgd.init(x)
    cost_first = problem.batch_cost(x)[0].mean().item()

    def iteration(x, state):
        return svgd.step_update(x, state, score(x, None))

    for _ in range(warm):  # first-call allocations and the build
        x, state = iteration(x, state)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    iter_ms = []
    with Launches() as counted:
        for _ in range(timed):
            t1 = time.perf_counter()
            x, state = iteration(x, state)
            torch.cuda.synchronize()
            iter_ms.append((time.perf_counter() - t1) * 1e3)
    want = {k: timed * v for k, v in PLANNING_ITER_KERNELS[depth].items()}
    counted.expect(f"{name} ({timed} iterations)", **want)
    if not (x.shape == (1024, 3, 7) and bool(torch.isfinite(x).all())):
        raise AssertionError(f"{name}: non-finite or misshapen particles")

    sc = score(x, None)
    sig = SignatureKernel(cfg.depth, cfg.pathsig_bw, mxu_precision=cfg.mxu_precision)
    stages = {"cost_and_gradient": host_ms(lambda: _grad_neg_cost(problem.batch_cost, x), 3),
              "gram_and_grad": host_ms(lambda: sig.gram_and_grad(x), 3),
              "update": host_ms(lambda: svgd.step_update(x, state, sc), 3)}
    row = {"phase": name, "batch": cfg.batch, "depth": cfg.depth,
           "timesteps": cfg.timesteps, "mxu_precision": cfg.mxu_precision,
           "ms_per_iter_median": statistics.median(iter_ms), "ms_per_iter_samples": iter_ms,
           "launches": {k: counted.counts[k] for k in want},
           "stages_ms": stages, "traced_iteration": traced(lambda: iteration(x, state)),
           "setup_s": setup_s, "mean_cost_first": cost_first,
           "mean_cost": sc.loss.mean().item(), "iterations": warm + timed}
    emit(row)
    if not row["mean_cost"] < cost_first:
        raise AssertionError(f"{name}: the mean cost did not fall: {row}")
    return row["launches"]


PLANNING_RUN_ITERS = 50  # planning_run's cut: robot_planning_full runs all 500


def phase_planning_run():
    """Bench's planning problem at ``PlannerConfig()``'s width (20 particles,
    depth 6, T = 200) for ``PLANNING_RUN_ITERS`` of its 500 iterations, end
    to end through ``run_optimisation`` and ``evaluate_trajectory`` (the
    learned sweep cell ``robot_planning_full`` runs the whole 500)."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_planning_problem
    from sigsvgd_tpu_torch.experiments.planning import (
        PlannerConfig, create_body_points, evaluate_trajectory, run_optimisation,
    )

    cfg = PlannerConfig(n_iter=PLANNING_RUN_ITERS)
    problem = build_planning_problem(device="cuda", timesteps=cfg.timesteps)
    t0 = time.perf_counter()
    with Launches() as counted:
        x, data = run_optimisation(problem, cfg,
                                   generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = (counted.counts["mxu_chain_fwd"], counted.counts["mxu_chain_bwd"])
    ev = evaluate_trajectory(problem, x)
    cost0, cost1 = data.loss[0].mean().item(), data.loss[-1].mean().item()
    # every trajectory passes through both end configurations, so their own
    # occupancy bounds the success rate (success needs max occupancy <= 0.2)
    ends = torch.stack([problem.q_start, problem.q_target])
    end_occ = torch.amax(problem.occupancy_fn(create_body_points(
        problem.robot.qs_to_joints_xs(ends), problem.n_body_points)), dim=-1)
    row = {"phase": "planning_run", "batch": cfg.batch, "n_iter": cfg.n_iter,
           "depth": cfg.depth, "mxu_precision": cfg.mxu_precision, "wall_s": wall_s,
           "ms_per_iter": wall_s * 1e3 / cfg.n_iter,
           "mean_cost_first": cost0, "mean_cost_last": cost1,
           "success_rate": ev["success"].float().mean().item(),
           "ee_path_length_mean": ev["ee_path_length"].mean().item(),
           "max_occ_at_start": end_occ[0].item(), "max_occ_at_target": end_occ[1].item(),
           "k8_launches": {"forward": launches[0], "backward": launches[1]},
           "finite": bool(torch.isfinite(x).all())}
    emit(row)
    counted.expect(f"planning_run ({cfg.n_iter} iterations)", mxu_chain_fwd=cfg.n_iter,
                   mxu_chain_bwd=cfg.n_iter)
    if not (row["finite"] and x.shape == (cfg.batch, 3, 7) and cost1 < cost0):
        raise AssertionError(f"planning_run: the mean cost did not fall: {row}")
    return launches


def planning_small_vs_cpu():
    """3 planning iterations at batch 8, T=50 on the card and on the CPU from
    the same knots: in fp32 ("highest") and through K8 ("default", the bf16
    twin on the CPU). Chained knots and losses at the chained-run tolerance,
    and the first score's K and repulsion gradient at K8's."""
    from sigsvgd_tpu_torch.experiments.planning import run_optimisation

    rtol, atol = PLAN_TOL
    for prec in ("highest", "default"):
        out = {}
        for dev in ("cuda", "cpu"):
            problem, cfg, _svgd, score = planning_setup(8, timesteps=50, precision=prec,
                                                        device=dev)
            lower, upper = (t.cpu() for t in problem.robot.joint_limits())
            x0 = lower + (upper - lower) * torch.rand(
                (8, 3, 7), generator=torch.Generator().manual_seed(4))
            x0 = x0.to(dev)
            sc = score(x0, None)
            cfg3 = dataclasses.replace(cfg, n_iter=3)
            x, data = run_optimisation(problem, cfg3, x0=x0)
            out[dev] = [t.detach().cpu() for t in (x, data.loss, sc.k_xx, sc.grad_k)]
        (x0c, l0, k0, g0), (x1, l1, k1, g1) = out["cuda"], out["cpu"]
        errs = {"x_abs": (x0c - x1).abs().max().item(),
                "loss_rel": ((l0 - l1).abs() / l1.abs()).max().item(),
                "k_scaled": ((k0 - k1).abs().max() / k1.abs().max()).item(),
                "grad_k_scaled": ((g0 - g1).abs().max() / g1.abs().max()).item()}
        emit({"phase": "small_solve_cuda_vs_cpu", "case": f"planning_{prec}",
              "compared": "knots and losses after 3 iterations; first K, grad_k",
              **errs})
        k_tol, g_tol = (1e-5, 1e-4) if prec == "highest" else K8_TOL
        ok = (torch.allclose(x0c, x1, rtol=rtol, atol=atol)
              and torch.allclose(l0, l1, rtol=rtol, atol=atol)
              and errs["k_scaled"] <= k_tol and errs["grad_k_scaled"] <= g_tol)
        if not ok:
            raise AssertionError(f"card and CPU planning disagree ({prec}): {errs}")


def pair_tiles(X: torch.Tensor, Y: torch.Tensor, ix, iy, h: float):
    """Scaled tiles ``[L, C, P]`` of the pairs ``(X[ix], Y[iy])``."""
    return ((X * h ** -0.5)[ix].permute(1, 2, 0).contiguous(),
            (Y * h ** -0.5)[iy].permute(1, 2, 0).contiguous())


def triu_tiles(X: torch.Tensor, h: float):
    """Scaled tiles of the upper-triangle pairs a ≤ b of ``X``, their
    ``gram_and_grad`` seeds (1 on the diagonal, 2 off it) and indices."""
    iu, ju = torch.triu_indices(X.shape[0], X.shape[0], device=X.device)
    seed = torch.where(iu == ju, 1.0, 2.0).to(X.dtype)
    return (*pair_tiles(X, X, iu, ju, h), seed, iu, ju)


def scatter(d, idx, n):
    """Per-path sums ``[n, L, C]`` (fp64) of pair-tile gradients ``d [L, C, P]``."""
    out = torch.zeros(n, d.shape[0], d.shape[1], dtype=torch.float64, device=d.device)
    return out.index_add_(0, idx, d.double().permute(2, 0, 1))


def twin_in_chunks(fn, xt, yt, g, chunk):
    """``fn(xt, yt, g)`` on ``chunk`` pairs at a time; outputs concatenated
    along the pair axis (the last)."""
    outs = [fn(xt[..., c0:c0 + chunk], yt[..., c0:c0 + chunk], g[c0:c0 + chunk])
            for c0 in range(0, xt.shape[-1], chunk)]
    return [torch.cat(o, dim=-1) for o in zip(*outs)]


def scaled_err(got, want) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def rel_cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return ((a - b).norm() / b.norm()).item(), (a @ b / (a.norm() * b.norm())).item()


def phase_k4():
    """K4's forward and fp32 backward against the twin at four pair lists:
    K against the fp32 twin; dX and dY (the pairs' tile gradients summed per
    path, as autograd returns them) against the twin in fp64, on the first
    16,384 pairs and, where the backward's persistent blocks each take
    several tiles, also on the last 16,384, which its loop's last passes
    solve. At the flagship list (asserted to hold more tiles than blocks in
    both kernels) the times of both kernels and of the twin, the bound and
    the residuals' memory; each row with both kernels' plans."""
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

    gen = torch.Generator(device="cuda").manual_seed(4)
    h = 4.0
    k_tol, d_tol = K4_TOL
    rows = {}
    cases = []

    def triu_case(name, n, L, C):
        xt, yt, seed, iu, ju = triu_tiles(smooth_paths(n, L, C, gen), h)
        cases.append((name, [n, L, C], iu, ju, n, n, xt, yt, seed))

    triu_case("flagship_triu", 1024, 40, 2)
    Xa, Ya = smooth_paths(77, 40, 2, gen), smooth_paths(64, 33, 2, gen)
    ia = torch.randint(0, 77, (5000,), generator=gen, device="cuda")
    ja = torch.randint(0, 64, (5000,), generator=gen, device="cuda")
    cases.append(("random_77x40_64x33", [[77, 40, 2], [64, 33, 2]], ia, ja, 77, 64,
                  *pair_tiles(Xa, Ya, ia, ja, h),
                  torch.randn(5000, generator=gen, device="cuda")))
    triu_case("triu_40x49x3", 40, 49, 3)
    triu_case("triu_64x17x7", 64, 17, 7)
    for name, shape, ix, iy, nx, ny, xt, yt, g in cases:
        P, Lx, Ly, C = xt.shape[2], xt.shape[0], yt.shape[0], xt.shape[1]
        plan = kf.launch_plan(P, Lx - 1, Ly - 1, C, "forward", "cuda")
        bplan = kf.launch_plan(P, Lx - 1, Ly - 1, C, "backward", "cuda")
        first_pass = bplan.blocks * bplan.pairs_per_tile  # pairs of the loop's first pass
        hold = min(P, 16384)
        held = torch.arange(hold, device="cuda")
        if P > first_pass:
            held = torch.cat([held, torch.arange(max(hold, P - hold), P, device="cuda")])
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
        torch.cuda.synchronize()
        fwd_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        dx, dy = kf.fused_backward(xt, yt, ck, rc, g)
        torch.cuda.synchronize()
        sl = (xt[..., held], yt[..., held], g[held])
        kp, dxp, dyp = twin_in_chunks(kf.fused_pairs_plain, *sl, 2048)
        _, dx64, dy64 = twin_in_chunks(
            lambda a, b, c: kf.fused_pairs_plain(a.double(), b.double(), c.double()), *sl, 2048)
        # a pair's tile gradient is its own, so the held slice of the
        # kernel's is the kernel's gradient of the held pairs
        dx, dy = dx[..., held], dy[..., held]
        ixh, iyh = ix[held], iy[held]
        dX, dY = scatter(dx, ixh, nx), scatter(dy, iyh, ny)
        dX64, dY64 = scatter(dx64, ixh, nx), scatter(dy64, iyh, ny)
        k_err = (k[held] - kp).abs().max().item()
        dx_err, dy_err = scaled_err(dX, dX64), scaled_err(dY, dY64)
        finite = bool(torch.isfinite(k).all() and torch.isfinite(dx).all()
                      and torch.isfinite(dy).all())
        row = {"phase": "k4_vs_plain", "case": name, "shape": shape, "pairs": P,
               "pairs_held": held.numel(), "tail_held": P > first_pass, "h": h,
               "k_max_abs_err": k_err,
               "dX_scaled_err_vs_fp64": dx_err, "dY_scaled_err_vs_fp64": dy_err,
               "plain_dX_scaled_err_vs_fp64": scaled_err(scatter(dxp, ixh, nx), dX64),
               "dX_max_abs_err_vs_fp64": (dX - dX64).abs().max().item(),
               "tile_dx_scaled_err_vs_fp64": scaled_err(dx, dx64),
               "plain_tile_dx_scaled_err_vs_fp64": scaled_err(dxp, dx64),
               "k_range": [k.min().item(), k.max().item()],
               "residual_mib": kf.residual_bytes(P, Lx - 1, Ly - 1) / 2**20,
               "forward_peak_mib": fwd_peak_mib, "finite": finite,
               "plan": plan.report(), "backward_plan": bplan.report()}
        del dx64, dy64, dxp, dyp
        if name == "flagship_triu":
            if plan.tiles <= plan.blocks or bplan.tiles <= bplan.blocks:
                raise AssertionError(f"K4 took {plan.tiles} forward tiles on {plan.blocks} "
                                     f"blocks and {bplan.tiles} backward tiles on "
                                     f"{bplan.blocks}: its loops' later passes went unchecked")
            row["fwd_ms"] = event_ms(lambda: kf.fused_forward(xt, yt, residuals=True), 3)
            row["bwd_ms"] = event_ms(lambda: kf.fused_backward(xt, yt, ck, rc, g), 3)
            row["values_only_fwd_ms"] = event_ms(
                lambda: kf.fused_forward(xt, yt, residuals=False), 3)
            row["blocks"] = {"forward": plan.blocks, "backward": bplan.blocks,
                             "bf16": kf.launch_plan(P, Lx - 1, Ly - 1, C, "bf16",
                                                    "cuda").blocks}
            row["plain_fwd_ms"] = event_ms(lambda: twin_in_chunks(
                lambda a, b, c: kf.fused_forward_plain(a, b, False), xt, yt, g, 16384), 1)
            row["plain_bwd_ms"] = event_ms(lambda: twin_in_chunks(
                lambda a, b, c: kf.fused_backward_plain(a, b, c), xt, yt, g, 8192), 1)
            row["fwd_bound"] = bound(kf.fused_flops(P, Lx, Ly, C)[0],
                                     kf.fused_bytes(P, Lx, Ly, C))
            row["bwd_bound"] = bound(kf.fused_flops(P, Lx, Ly, C, "backward")[0],
                                     kf.fused_bytes(P, Lx, Ly, C, "backward"))
            rows["flagship"] = dict(row, tiles=(xt, yt, g, ck, rc))
        emit(row)
        if not (finite and k_err <= k_tol and dx_err <= d_tol and dy_err <= d_tol):
            raise AssertionError(f"K4 disagrees with its twin: {row}")
    return rows["flagship"]


def phase_k6(k4):
    """K6 against its bf16 twin and against K4's backward on the same
    residuals, at two small lists and at the flagship pair list, where each
    persistent block takes several tiles of pair couples (asserted); each
    row with K6's plan; its time against K4's backward there."""
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

    gen = torch.Generator(device="cuda").manual_seed(6)
    h = 4.0
    for n, L, C in ((128, 40, 2), (77, 41, 4)):
        xt, yt, g = triu_tiles(smooth_paths(n, L, C, gen), h)[:3]  # P odd at n = 77
        k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
        dx, dy = kf.fused_backward_bf16(xt, yt, ck, rc, g)
        t0 = time.perf_counter()
        dxp, dyp = kf.fused_backward_bf16_plain(xt, yt, ck, rc, g)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        dx32, dy32 = kf.fused_backward(xt, yt, ck, rc, g)
        got = torch.cat([dx.flatten(), dy.flatten()])
        rel, cos = rel_cos(got, torch.cat([dxp.flatten(), dyp.flatten()]))
        rel32, cos32 = rel_cos(got, torch.cat([dx32.flatten(), dy32.flatten()]))
        twin_rel32, twin_cos32 = rel_cos(torch.cat([dxp.flatten(), dyp.flatten()]),
                                         torch.cat([dx32.flatten(), dy32.flatten()]))
        finite = bool(torch.isfinite(dx).all() and torch.isfinite(dy).all())
        plan = kf.launch_plan(xt.shape[2], L - 1, L - 1, C, "bf16", "cuda")
        row = {"phase": "k6_vs_plain", "shape": [n, L, C], "pairs": xt.shape[2], "h": h,
               "plan": plan.report(),
               "rel_vs_twin": rel, "cos_vs_twin": cos,
               "max_abs_err_vs_twin": (got - torch.cat([dxp.flatten(), dyp.flatten()])
                                       ).abs().max().item(),
               "rel_vs_fp32": rel32, "cos_vs_fp32": cos32,
               "twin_rel_vs_fp32": twin_rel32, "twin_cos_vs_fp32": twin_cos32,
               "twin_s": twin_s, "finite": finite}
        emit(row)
        ok = (finite and rel <= K6_TOL[0] and cos >= K6_TOL[1]
              and rel32 < K6_FP32_TOL[0] and cos32 > K6_FP32_TOL[1])
        if not ok:
            raise AssertionError(f"K6 disagrees with its twin or K4's backward: {row}")

    xt, yt, g, ck, rc = k4["tiles"]
    P, Lx, Ly, C = xt.shape[2], xt.shape[0], yt.shape[0], xt.shape[1]
    plan = kf.launch_plan(P, Lx - 1, Ly - 1, C, "bf16", "cuda")
    if plan.tiles <= plan.blocks:
        raise AssertionError(f"K6 took {plan.tiles} tiles of pair couples on {plan.blocks} "
                             "blocks: its loop's later passes went unchecked")
    dx, dy = kf.fused_backward_bf16(xt, yt, ck, rc, g)
    got = torch.cat([dx.flatten(), dy.flatten()])
    del dx, dy
    dx32, dy32 = kf.fused_backward(xt, yt, ck, rc, g)
    rel32, cos32 = rel_cos(got, torch.cat([dx32.flatten(), dy32.flatten()]))
    del dx32, dy32
    plain = {}

    def run_plain():
        plain["d"] = kf.fused_backward_bf16_plain(xt, yt, ck, rc, g)

    plain_ms = event_ms(run_plain, 1)
    twin = torch.cat([t.flatten() for t in plain.pop("d")])
    rel, cos = rel_cos(got, twin)
    fp32, bf16 = kf.fused_flops(P, Lx, Ly, C, "bf16")
    t_ops = fp32 / PEAK_FP32_FLOPS + bf16 / PEAK_BF16_SIMT_FLOPS
    t_bytes = kf.fused_bytes(P, Lx, Ly, C, "bf16") / PEAK_BYTES
    row = {"phase": "k6_vs_plain", "case": "flagship_triu", "shape": [1024, 40, 2],
           "pairs": P, "plan": plan.report(), "rel_vs_twin": rel,
           "cos_vs_twin": cos,
           "max_abs_err": (got - twin).abs().max().item(),
           "rel_vs_fp32": rel32, "cos_vs_fp32": cos32,
           "k6_ms": event_ms(lambda: kf.fused_backward_bf16(xt, yt, ck, rc, g), 3),
           "k4_bwd_ms": event_ms(lambda: kf.fused_backward(xt, yt, ck, rc, g), 3),
           "plain_ms": plain_ms, "flops": fp32, "bf16_flops": bf16,
           "bytes": kf.fused_bytes(P, Lx, Ly, C, "bf16"),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    emit(row)
    if not (rel <= K6_TOL[0] and cos >= K6_TOL[1]
            and rel32 < K6_FP32_TOL[0] and cos32 > K6_FP32_TOL[1]):
        raise AssertionError(f"K6 disagrees with its twin or K4's backward at the "
                             f"flagship list: {row}")
    return row


def phase_streamed_gram():
    """``gram(X, Y)`` above the dense limit at [1024, 40, 2] × [1024, 40, 2]
    and its gradient with respect to X; rows 0..63 and 960..1023 held
    against the twin (the tail's pairs fall in the last passes of K4's
    persistent backward, asserted), with the backward's plan."""
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    gen = torch.Generator(device="cuda").manual_seed(7)
    h = 4.0
    X, Y = smooth_paths(1024, 40, 2, gen), smooth_paths(1024, 40, 2, gen)
    kern = SignatureKernel(dyadic_order=3, bandwidth=h)

    def run():
        x = X.clone().requires_grad_(True)
        K = kern.gram(x, Y)
        (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach(), dX

    (K, dX), counted, wall_ms, peak_mib = run_counted(run)
    launches = counted.counts
    _, chunk, nb = kern._chunk_plan(39, 39, 1024 * 1024, 2, X.device, h)

    bplan = kf.launch_plan(chunk, 39, 39, 2, "backward", "cuda")
    if chunk <= bplan.blocks * bplan.pairs_per_tile:
        raise AssertionError(f"streamed_gram: {chunk} pairs a chunk in one pass of "
                             f"{bplan.blocks} backward blocks")
    rows = torch.cat([torch.arange(64), torch.arange(960, 1024)]).cuda()
    nr = rows.numel()
    iu = rows.repeat_interleave(1024)
    ju = torch.arange(1024, device="cuda").repeat(nr)
    xt, yt = pair_tiles(X, Y, iu, ju, h)
    ones = torch.ones(iu.shape[0], device="cuda")
    (kp,) = twin_in_chunks(lambda a, b, c: kf.fused_forward_plain(a, b, False),
                           xt, yt, ones, 8192)
    _, dx64, _ = twin_in_chunks(
        lambda a, b, c: kf.fused_pairs_plain(a.double(), b.double(), c.double()),
        xt, yt, ones, 2048)
    dX64 = scatter(dx64, torch.arange(nr, device="cuda").repeat_interleave(1024), nr) * h ** -0.5
    k_err = (K[rows].reshape(-1) - kp).abs().max().item()
    dx_err = scaled_err(dX[rows], dX64)
    finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
    row = {"phase": "streamed_gram", "shape": [[1024, 40, 2], [1024, 40, 2]],
           "pairs": 1024 * 1024, "h": h, "chunk": chunk, "chunks": nb,
           "wall_ms": wall_ms, "launches": launches, "peak_allocated_mib": peak_mib,
           "backward_plan": bplan.report(), "rows_held": [[0, 63], [960, 1023]],
           "k_max_abs_err": k_err, "dx_scaled_err_vs_fp64": dx_err,
           "k_range": [K.min().item(), K.max().item()], "finite": finite}
    emit(row)
    counted.expect("streamed_gram", fused_forward=2 * nb, fused_backward=nb)
    if not (finite and K.shape == (1024, 1024) and k_err <= K4_TOL[0]
            and dx_err <= K4_TOL[1]):
        raise AssertionError(f"streamed_gram disagrees with the twin: {row}")
    return row

def small_twin(xt, yt, g, dtype=torch.float64):
    """K7's twin on the pairs of ``xt``, ``yt`` in ``dtype``: ``(k, fac, dx,
    dy)`` for cotangent ``g``."""
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    xt, yt, g = xt.to(dtype), yt.to(dtype), g.to(dtype)
    k, fac = ks.small_forward_plain(xt, yt, residuals=True)
    return (k, fac, *ks.small_backward_plain(xt, yt, fac, g))


def time_k7(xt, yt, g, fac) -> dict:
    """K7's three launches on the pair list ``xt``, ``yt`` (CUDA events, 3
    runs after a warm one of each, so that no timed run waits for the
    allocator to find a new residual's memory) and its twin's (one run by
    chunks of 65,536 pairs), with the bounds, the residual's memory and
    each launch's plan."""
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    P, Lx, Ly, C = xt.shape[2], xt.shape[0], yt.shape[0], xt.shape[1]

    def twin(residuals):
        for c0 in range(0, P, 65536):
            c1 = min(P, c0 + 65536)
            if residuals is None:
                ks.small_backward_plain(xt[..., c0:c1], yt[..., c0:c1], fac[..., c0:c1],
                                        g[c0:c1])
            else:
                ks.small_forward_plain(xt[..., c0:c1], yt[..., c0:c1], residuals)

    ks.small_forward(xt, yt, residuals=False)
    ks.small_forward(xt, yt, residuals=True)
    ks.small_backward(xt, yt, fac, g)
    out = {"fwd_ms": event_ms(lambda: ks.small_forward(xt, yt, residuals=False), 3),
           "fwd_res_ms": event_ms(lambda: ks.small_forward(xt, yt, residuals=True), 3),
           "bwd_ms": event_ms(lambda: ks.small_backward(xt, yt, fac, g), 3),
           "plain_fwd_ms": event_ms(lambda: twin(False), 1),
           "plain_fwd_res_ms": event_ms(lambda: twin(True), 1),
           "plain_bwd_ms": event_ms(lambda: twin(None), 1),
           "residual_mib": ks.residual_bytes(P, Lx - 1, Ly - 1) / 2**20,
           "plans": k7_plans(Lx - 1, Ly - 1, C, P)}
    for part, key in (("forward", "fwd"), ("residuals", "fwd_res"), ("backward", "bwd")):
        out[f"{key}_bound"] = bound(ks.small_flops(P, Lx, Ly, C, part),
                                    ks.small_bytes(P, Lx, Ly, C, part))
    return out


def k7_plans(lx1, ly1, C, P) -> dict:
    """The plan of each of K7's three launches on the card (``small_plan``:
    lanes, spans, runs, tiles, resident blocks, threads, stages, traffic,
    sector share)."""
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    return {part: ks.launch_plan(lx1, ly1, C, P, part, "cuda").report()
            for part in ks.PARTS}


def phase_k7():
    """K7's forward (values only and with the residual) and backward against
    the fp32 twin at five pair lists: k and fac to atol 3e-5; dX and dY (the
    pairs' tile gradients summed per path) scaled by their max to atol
    5e-5; each also against the twin in fp64, reported, not gated. Held
    pairs: the first 16,384 and, where the launches' persistent blocks each
    take several tiles, the last 16,384. Each row carries the three
    launches' plans. At the flagship list (its last 16,384 pairs asserted
    to lie beyond every launch's first pass) the times of the three
    launches and of the twin, the bounds and the residual's memory."""
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    gen = torch.Generator(device="cuda").manual_seed(8)
    h = 4.0
    k_tol, d_tol = K7_TOL
    rows = {}
    cases = []

    def triu_case(name, n, L, C):
        xt, yt, seed, iu, ju = triu_tiles(smooth_paths(n, L, C, gen), h)
        cases.append((name, [n, L, C], iu, ju, n, n, xt, yt, seed))

    triu_case("flagship_triu", 1024, 40, 2)
    Xa, Ya = smooth_paths(77, 40, 2, gen), smooth_paths(64, 33, 2, gen)
    ia = torch.randint(0, 77, (5000,), generator=gen, device="cuda")
    ja = torch.randint(0, 64, (5000,), generator=gen, device="cuda")
    cases.append(("random_77x40_64x33", [[77, 40, 2], [64, 33, 2]], ia, ja, 77, 64,
                  *pair_tiles(Xa, Ya, ia, ja, h),
                  torch.randn(5000, generator=gen, device="cuda")))
    triu_case("triu_40x64x3", 40, 64, 3)
    triu_case("triu_64x41x4", 64, 41, 4)
    triu_case("triu_256x20x8", 256, 20, 8)
    for name, shape, ix, iy, nx, ny, xt, yt, g in cases:
        P, Lx, Ly, C = xt.shape[2], xt.shape[0], yt.shape[0], xt.shape[1]
        plans = k7_plans(Lx - 1, Ly - 1, C, P)
        hold = min(P, 16384)
        held = torch.arange(hold, device="cuda")
        # the pairs the launches' first pass takes: every block's first tile
        first = min(pl["blocks"] * pl["pairs_per_tile"] for pl in plans.values())
        tail = P > first
        if tail:
            held = torch.cat([held, torch.arange(max(hold, P - hold), P, device="cuda")])
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (kv,) = ks.small_forward(xt, yt, residuals=False)
        k, fac = ks.small_forward(xt, yt, residuals=True)
        torch.cuda.synchronize()
        fwd_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        dx, dy = ks.small_backward(xt, yt, fac, g)
        torch.cuda.synchronize()
        sl = (xt[..., held], yt[..., held], g[held])
        kp, facp, dxp, dyp = small_twin(*sl, torch.float32)
        k64, fac64, dx64, dy64 = small_twin(*sl)
        ixh, iyh = ix[held], iy[held]
        dX, dY = scatter(dx[..., held], ixh, nx), scatter(dy[..., held], iyh, ny)
        dXp, dYp = scatter(dxp, ixh, nx), scatter(dyp, iyh, ny)
        dX64, dY64 = scatter(dx64, ixh, nx), scatter(dy64, iyh, ny)
        fac_h = fac[..., held]
        k_err = (k[held] - kp).abs().max().item()
        fac_err = (fac_h - facp).abs().max().item()
        dx_err, dy_err = scaled_err(dX, dXp), scaled_err(dY, dYp)
        finite = bool(torch.isfinite(k).all() and torch.isfinite(fac).all()
                      and torch.isfinite(dx).all() and torch.isfinite(dy).all())
        row = {"phase": "k7_vs_plain", "case": name, "shape": shape, "pairs": P,
               "plans": plans, "first_pass_pairs": first,
               "pairs_held": held.numel(), "tail_held": tail, "h": h,
               "k_max_abs_err": k_err, "fac_max_abs_err": fac_err,
               "values_only_equal": bool(torch.equal(kv, k)),
               "dX_scaled_err": dx_err, "dY_scaled_err": dy_err,
               "vs_fp64": {"k": (k[held].double() - k64).abs().max().item(),
                           "plain_k": (kp.double() - k64).abs().max().item(),
                           "fac": (fac_h.double() - fac64).abs().max().item(),
                           "dX_scaled": scaled_err(dX, dX64),
                           "plain_dX_scaled": scaled_err(dXp, dX64),
                           "dY_scaled": scaled_err(dY, dY64),
                           "plain_dY_scaled": scaled_err(dYp, dY64)},
               "k_range": [k.min().item(), k.max().item()],
               "residual_mib": ks.residual_bytes(P, Lx - 1, Ly - 1) / 2**20,
               "forward_peak_mib": fwd_peak_mib, "finite": finite}
        del k64, fac64, dx64, dy64, fac_h
        if name == "flagship_triu":
            if not (tail and P - hold >= first):
                raise AssertionError(f"K7's first passes took {first} of {P} pairs: its "
                                     "loops' later passes went unchecked")
            row.update(time_k7(xt, yt, g, fac))
            rows["flagship"] = row
        emit(row)
        ok = (finite and row["values_only_equal"] and k_err <= k_tol and fac_err <= k_tol
              and dx_err <= d_tol and dy_err <= d_tol)
        if not ok:
            raise AssertionError(f"K7 disagrees with its twin: {row}")
        del xt, yt, k, fac, dx, dy
    return rows["flagship"]


def phase_k3():
    """K3 against its twin and against K1's K (both bit for bit: the statics
    and the forward sweep round as the twin does) at [1024, 40, 2],
    [333, 40, 2], [40, 64, 2], and at C = 8 ([1024, 16, 8], τ-like knots, and
    [300, 16, 8]); at n = 1024 its time beside K1's and the twin's,
    its plan (band rows, tiles, length bucket), the registers of its
    instantiation and the issue floor its SASS implies; at [1024, 16, 8] its
    time and the twin's."""
    from sigsvgd_tpu_torch.kernels import _build
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    gen = torch.Generator(device="cuda").manual_seed(3)
    h = 4.0
    out = None
    regs = ptxas_functions(_build.build_all()["sigkernel_block"])
    lib = _build._lib_path(_build.CSRC / "sigkernel_block.cu")
    for n, L, C in ((1024, 40, 2), (333, 40, 2), (40, 64, 2), (1024, 16, 8), (300, 16, 8)):
        X = smooth_paths(n, L, C, gen)
        K = kb.block_gram(X, h)
        Kp = kb.block_gram_plain(X, h)
        K64 = kb.block_gram_plain(X.double(), h)
        torch.cuda.synchronize()
        k_err = (K - Kp).abs().max().item()
        plan = kb.block_values_plan(n, L, C)
        tag = f"block_values_kernelILi{plan.bucket}ELi{C}E"
        row = {"phase": "k3_vs_plain", "shape": [n, L, C], "h": h,
               "k_max_abs_err": k_err, "bit_equal_twin": bool(torch.equal(K, Kp)),
               "k_err_vs_fp64": {"kernel": (K.double() - K64).abs().max().item(),
                                 "plain": (Kp.double() - K64).abs().max().item()},
               "finite": bool(torch.isfinite(K).all()),
               "band_rows": plan.band_rows, "bucket": plan.bucket, "tiles": plan.tiles,
               "registers": next((r["registers"] for f, r in regs.items() if tag in f), None)}
        row["bit_equal_k1"] = bool(torch.equal(K, kb.block_gram_and_grad(X, h)[0]))
        if n == 1024:
            row.update(kernel_ms=event_ms(lambda: kb.block_gram(X, h), 5),
                       plain_ms=event_ms(lambda: kb.block_gram_plain(X, h), 1),
                       library_ms=None,
                       **bound(kb.block_values_flops(n, L, C),
                               kb.block_values_bytes(n, L, C)),
                       **k3_issue_floor(n, sass_counts(lib, tag), plan.bands),
                       k1_ms=event_ms(lambda: kb.block_gram_and_grad(X, h), 3))
            if (L, C) == (40, 2):
                out = row
        emit(row)
        if not (row["finite"] and row["bit_equal_twin"] and row["bit_equal_k1"]):
            raise AssertionError(f"K3 disagrees with K1 or its twin: {row}")
    return out


def run_counted(fn):
    """``fn()`` once after a warm-up, with every kernel's launches counted
    around it: ``(out, Launches, wall ms, peak allocated MiB)``."""
    fn()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Launches() as counted:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    return out, counted, wall_ms, peak_mib


def phase_lambda0_streamed_gram(kern, X, Y):
    """The calibrated flagship kernel's ``gram(X, Y)`` on τ of two flagship
    rollouts, [1024, 40, 2] × [1024, 40, 2] (1,048,576 pairs, above the
    dense limit), and its gradient with respect to X: wall time, peak
    memory, exactly 2 K7 forward and 1 K7 backward launches (one chunk) and
    no other kernel; rows 0..63 and 960..1023 held against the twin. Then
    K7's three launches timed at this pair list."""
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    h = kern.bandwidth
    n, m = X.shape[0], Y.shape[0]

    def run():
        x = X.clone().requires_grad_(True)
        K = kern.gram(x, Y)
        (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach(), dX

    (K, dX), launches, wall_ms, peak_mib = run_counted(run)
    _, chunk, nb = kern._chunk_plan(X.shape[1] - 1, Y.shape[1] - 1, n * m, X.shape[2],
                                    X.device, h)
    rows = torch.cat([torch.arange(64), torch.arange(n - 64, n)]).cuda()
    nr = rows.numel()
    iu, ju = rows.repeat_interleave(m), torch.arange(m, device="cuda").repeat(nr)
    xt, yt = pair_tiles(X, Y, iu, ju, h)
    ones = torch.ones(iu.shape[0], device="cuda")
    kp, _, dxp, _ = small_twin(xt, yt, ones, torch.float32)
    k64, _, dx64, _ = small_twin(xt, yt, ones)
    owner = torch.arange(nr, device="cuda").repeat_interleave(m)
    dXp = scatter(dxp, owner, nr) * h ** -0.5
    dX64 = scatter(dx64, owner, nr) * h ** -0.5
    k_err = (K[rows].reshape(-1) - kp).abs().max().item()
    dx_err = scaled_err(dX[rows], dXp)
    finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
    row = {"phase": "lambda0_streamed_gram", "kernel": repr(kern),
           "dx_max_abs_err": (dX[rows] - dXp).abs().max().item(),
           "shape": [list(X.shape), list(Y.shape)], "pairs": n * m, "h": h,
           "chunk": chunk, "chunks": nb, "wall_ms": wall_ms, "launches": launches.counts,
           "peak_allocated_mib": peak_mib, "rows_held": [[0, 63], [n - 64, n - 1]],
           "k_max_abs_err": k_err, "dx_scaled_err": dx_err,
           "vs_fp64": {"k": (K[rows].reshape(-1).double() - k64).abs().max().item(),
                       "dX_scaled": scaled_err(dX[rows], dX64),
                       "plain_dX_scaled": scaled_err(dXp, dX64)},
           "k_range": [K.min().item(), K.max().item()], "finite": finite}
    del xt, yt, kp, dxp, k64, dx64
    launches.expect("lambda0_streamed_gram", small_forward=2, small_backward=1)
    if not (finite and K.shape == (n, m) and k_err <= K7_TOL[0] and dx_err <= K7_TOL[1]):
        raise AssertionError(f"lambda0_streamed_gram disagrees with the twin: {row}")

    # K7's launches at this pair list, timed (not counted: the path's run is above)
    idx = torch.arange(n * m, device="cuda")
    xt, yt = pair_tiles(X, Y, idx // m, idx % m, h)
    del idx
    k, fac = ks.small_forward(xt, yt, residuals=True)
    row["k7_at_this_list"] = time_k7(xt, yt, torch.ones(n * m, device="cuda"), fac)
    del xt, yt, k, fac
    emit(row)
    return row


def phase_gram_sym(kern, X):
    """``gram_sym`` of the calibrated flagship kernel on τ [1024, 40, 2]:
    exactly 1 K3 launch and no other kernel, K equal to K1's K bit for bit;
    then at τ-like knots [1024, 16, 8] (C = 8, inside the JAX package's block
    envelope and K1's): 1 K3 launch and no K7, K the twin's bit for bit.
    Returns the τ row with the knots' row under ``"c8"``."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    K, launches, wall_ms, peak_mib = run_counted(lambda: kern.gram_sym(X))
    K1, _ = kb.block_gram_and_grad(X, kern.bandwidth)
    row = {"phase": "gram_sym", "kernel": repr(kern), "shape": list(X.shape),
           "wall_ms": wall_ms, "launches": launches.counts, "peak_allocated_mib": peak_mib,
           "bit_equal_k1": bool(torch.equal(K, K1)), "requires_grad": K.requires_grad,
           "finite": bool(torch.isfinite(K).all())}
    emit(row)
    launches.expect("gram_sym", block_gram=1)
    if not (row["finite"] and row["bit_equal_k1"]):
        raise AssertionError(f"gram_sym disagrees with K1: {row}")
    row["c8"] = gram_sym_c8()
    return row


def gram_sym_c8() -> dict:
    """``gram_sym`` at λ=0 on τ-like knots [1024, 16, 8] (bandwidth 4):
    exactly 1 K3 launch and no other kernel, K the twin's bit for bit."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    X = smooth_paths(1024, 16, 8, torch.Generator(device="cuda").manual_seed(16))
    kern = SignatureKernel(0, 4.0)
    K, launches, wall_ms, peak_mib = run_counted(lambda: kern.gram_sym(X))
    row = {"phase": "gram_sym", "kernel": repr(kern), "shape": list(X.shape),
           "wall_ms": wall_ms, "launches": launches.counts, "peak_allocated_mib": peak_mib,
           "bit_equal_twin": bool(torch.equal(K, kb.block_gram_plain(X, 4.0))),
           "requires_grad": K.requires_grad, "finite": bool(torch.isfinite(K).all())}
    emit(row)
    launches.expect("gram_sym c8", block_gram=1)
    if not (row["finite"] and row["bit_equal_twin"]):
        raise AssertionError(f"gram_sym at C = 8 disagrees with the twin: {row}")
    return row


class lambda3_twins:
    """Within the block, the λ=3 ``gram_and_grad`` routes' kernels (K2, K4's
    forward and fp32 backward) run their plain twins on the card, uncounted,
    in the inputs' precision: the same route with the twins in the
    kernels' place."""

    def __enter__(self):
        from sigsvgd_tpu_torch.kernels import sigkernel as sk
        from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
        from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

        self.saved = sk.block3_gram_and_grad, kf.fused_forward, kf.fused_backward
        sk.block3_gram_and_grad = kb3.block3_gram_and_grad_plain
        kf.fused_forward = kf.fused_forward_plain
        kf.fused_backward = lambda xt, yt, ck, rc, g: kf.fused_backward_plain(xt, yt, g)

    def __exit__(self, *exc):
        from sigsvgd_tpu_torch.kernels import sigkernel as sk
        from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

        sk.block3_gram_and_grad, kf.fused_forward, kf.fused_backward = self.saved


def phase_gram_and_grad_routes() -> dict:
    """``gram_and_grad`` at λ=0 and λ=3 on bench's planning knots ([1024,
    3, 7], uniform in the Panda's joint limits, the planner's bandwidth 1.5:
    inside the JAX package's block envelopes) and beyond the block envelope
    (L·C > 128: [64, 41, 4] at λ=0, [64, 33, 4] at λ=3). The knots launch
    K1 (K2) once and nothing else, the others K7's (K4's) forward and
    backward once each. K and dX match the same route with the twins in the
    kernels' place (λ=0: on the CPU, K atol 3e-5, dX scaled 5e-5; λ=3: on
    the card, ``lambda3_twins``, K atol 1e-4 against the fp32 route, dX
    scaled 4e-4 against it in fp64: the λ=3 sweeps carry the CPU's and the
    card's ``exp`` roundings apart by ~1e-4 at L = 33).
    On the knots the parent's route, the pair list
    (``SignatureKernel._pair_gram_and_grad``: K7 at λ=0, K4 at λ=3), runs
    beside the block kernel: its launches, its distance from the block
    route, and both timed in turns (block, pair, pair, block; wall ms a call
    over 10 calls). Rows by order, then case."""
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    gen = torch.Generator(device="cuda").manual_seed(9)
    knots = uniform_knots(1024, gen)
    pair_k7 = {"small_forward": 1, "small_backward": 1}
    pair_k4 = {"fused_forward": 1, "fused_backward": 1}
    cases = (
        (0, "planning_knots_c7", knots, KNOT_BW, {"block_gram_and_grad": 1}, pair_k7),
        (0, "lc164", smooth_paths(64, 41, 4, gen), 4.0, pair_k7, None),
        (3, "planning_knots_c7", knots, KNOT_BW, {"block3_gram_and_grad": 1}, pair_k4),
        (3, "lc132", smooth_paths(64, 33, 4, gen), 4.0, pair_k4, None))
    rows = {0: {}, 3: {}}
    for order, name, X, h, want, pair_want in cases:
        phase = f"lambda{order}_gram_and_grad"
        kern = SignatureKernel(order, bandwidth=h)
        (K, dX), launches, wall_ms, peak_mib = run_counted(lambda: kern.gram_and_grad(X))
        if order == 0:
            k_tol, dx_tol = K7_TOL
            Kc, ref = (t.cuda() for t in kern.gram_and_grad(X.cpu()))
        else:
            k_tol, dx_tol = K2_TOL
            with lambda3_twins():
                Kc = kern.gram_and_grad(X)[0]
                ref = kern.gram_and_grad(X.double())[1]
        k_err = (K - Kc).abs().max().item()
        dx_err = scaled_err(dX.double(), ref.double())
        row = {"phase": phase, "case": name, "shape": list(X.shape), "h": h,
               "wall_ms": wall_ms, "launches": launches.counts,
               "peak_allocated_mib": peak_mib, "k_max_abs_err": k_err,
               "dx_scaled_err": dx_err,
               "compared": "K and dX against the CPU route" if order == 0 else
                           "K against the route with the twins on the card, dX against "
                           "it in fp64",
               "k_range": [K.min().item(), K.max().item()],
               "finite": bool(torch.isfinite(K).all() and torch.isfinite(dX).all())}
        if pair_want:
            (Kq, dXq), pair_launches, _, pair_peak = run_counted(
                lambda: kern._pair_gram_and_grad(X, h))
            block = lambda: kern.gram_and_grad(X)  # noqa: E731
            pair = lambda: kern._pair_gram_and_grad(X, h)  # noqa: E731
            turns = [host_ms(fn, 10) for fn in (block, pair, pair, block)]
            row["pair_route"] = {
                "launches": pair_launches.counts, "peak_allocated_mib": pair_peak,
                "k_max_abs_diff": (K - Kq).abs().max().item(),
                "dx_scaled_diff": scaled_err(dX, dXq),
                "ms_in_turns": {"block": [turns[0], turns[3]], "pair": turns[1:3]}}
            row["block_route_ms"] = statistics.mean([turns[0], turns[3]])
            row["pair_route_ms"] = statistics.mean(turns[1:3])
            del Kq, dXq
        emit(row)
        launches.expect(f"{phase} {name}", **want)
        if pair_want:
            pair_launches.expect(f"{phase} {name} (pair list)", **pair_want)
        if not (row["finite"] and k_err <= k_tol and dx_err <= dx_tol):
            raise AssertionError(f"{phase} disagrees with its twins' route: {row}")
        rows[order][name] = row
    return rows


class k5_twins:
    """Within the block, K5's wrappers run its plain twins (``dtype``: the
    backward's; the forward stays fp32), on the card, uncounted: the same
    route with the twins in the kernels' place."""

    def __init__(self, bwd_dtype=torch.float32):
        self.bwd_dtype = bwd_dtype

    def __enter__(self):
        from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

        self.saved = kt.tiled_forward, kt.tiled_backward
        dt = self.bwd_dtype
        kt.tiled_forward = kt.tiled_forward_plain
        kt.tiled_backward = lambda z, ck, g: kt.tiled_backward_plain(
            z.to(dt), ck.to(dt), g.to(dt)).float()

    def __exit__(self, *exc):
        from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

        kt.tiled_forward, kt.tiled_backward = self.saved


def k5_twin(z, g, dtype, chunk):
    """K5's twin on ``z [lx1, ly1, P]`` in ``dtype``, ``chunk`` pairs at a
    time: ``(k, ck, dz)`` for cotangent ``g``."""
    from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

    outs = []
    for c0 in range(0, z.shape[-1], chunk):
        zc, gc = z[..., c0:c0 + chunk].to(dtype), g[c0:c0 + chunk].to(dtype)
        k, ck = kt.tiled_forward_plain(zc, with_ck=True)
        outs.append((k, ck, kt.tiled_backward_plain(zc, ck, gc)))
    return [torch.cat(o, dim=-1) for o in zip(*outs)]


def k_excess(got, want, rtol, atol=1e-6) -> float:
    """The largest ``|got − want| − (atol + rtol·|want|)``: ≤ 0 holds."""
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def phase_k5(tau):
    """K5's forward (values only and with its checkpoints) and backward
    against the fp32 twin at eight lists: the flagship linear list (the
    upper triangle of τ [1024, 40, 2] of a flagship rollout with linear
    statics, 524,800 pairs, cotangent 1 on the diagonal and 2 off it, as
    ``gram_and_grad`` seeds it; the first and last 16,384 pairs held, the
    last in a later wave of the backward's blocks, asserted), 2,561 pairs of
    [3, 3] increments, [3, 40, 40] at scale 0.05, a ly1 = 48 list, a
    rectangular [39, 17] one, a [7, 9] one and two of one band, [1, 5] and
    [1, 48] (normal increments, scale 0.3, as
    ``tests/test_pallas_sigkernel.py`` draws them; 1, 2, 4, 8 and 16 lanes
    a pair): k and the checkpoints (in the twin's layout) to rtol 2e-5 /
    atol 1e-6 and dz scaled by max|dz| to atol 5e-4 (1e-4 and 1e-3 at
    [3, 40, 40]); each also against the twin in fp64, reported. At the
    flagship list the plan, the registers and spills of every K5 function,
    the times of the three launches and of the twin (by chunks of 65,536
    pairs), the bounds and the checkpoints' memory."""
    from sigsvgd_tpu_torch.kernels import _build
    from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

    gen = torch.Generator(device="cuda").manual_seed(15)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = tau.shape[0]
    iu, ju = torch.triu_indices(n, n, device="cuda")
    cases = [("flagship_linear_triu", [n, 40, 2],
              kt.pair_increments(tau, tau, iu, ju, None).contiguous(),
              torch.where(iu == ju, 1.0, 2.0))]
    del iu, ju
    for name, b, lx1, ly1, scale in (("normal_2561x3x3", 2561, 3, 3, 0.3),
                                     ("mpc_3x40x40", 3, 40, 40, 0.05),
                                     ("ly48_300x6x48", 300, 6, 48, 0.3),
                                     ("rect_500x39x17", 500, 39, 17, 0.3),
                                     ("g2_1500x7x9", 1500, 7, 9, 0.3),
                                     ("lx1_1_3000x1x5", 3000, 1, 5, 0.3),
                                     ("lx1_1_700x1x48", 700, 1, 48, 0.3)):
        z = (torch.randn((lx1, ly1, b), generator=gen, device="cuda") * scale / 64.0)
        cases.append((name, [b, lx1, ly1], z.contiguous(),
                      torch.randn(b, generator=gen, device="cuda")))
    out = None
    for name, shape, z, g in cases:
        lx1, ly1, P = z.shape
        k_rtol, dz_tol = (1e-4, 1e-3) if name.startswith("mpc") else K5_TOL
        fwd_res, bwd_res = kt.resident_blocks(ly1)
        plan = kt.tiled_plan(P, lx1, ly1, bwd_res * sms)
        hold = min(P, 16384)
        held = torch.arange(hold, device="cuda")
        # the last tile runs in a later wave of blocks than the first
        tail = plan.tiles > plan.resident
        if tail:
            held = torch.cat([held, torch.arange(max(hold, P - hold), P, device="cuda")])
        (kv,) = kt.tiled_forward(z, with_ck=False)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k, ck = kt.tiled_forward(z, with_ck=True)
        dz = kt.tiled_backward(z, ck, g)
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        zh, gh = z[..., held], g[held]
        kp, ckp, dzp = k5_twin(zh, gh, torch.float32, 16384)
        k64, _, dz64 = k5_twin(zh, gh, torch.float64, 16384)
        kh, ckh, dzh = k[held], kt.twin_checkpoints(ck, lx1, ly1, P, held), dz[..., held]
        k_err = k_excess(kh, kp, k_rtol)
        ck_err = k_excess(ckh, ckp, k_rtol)
        dz_err = scaled_err(dzh, dzp)
        finite = bool(torch.isfinite(k).all() and torch.isfinite(dz).all())
        row = {"phase": "k5_vs_plain", "case": name, "shape": shape, "pairs": P,
               "lanes_a_pair": plan.g, "tiles": plan.tiles,
               "resident_blocks": {"forward": fwd_res * sms, "backward": bwd_res * sms},
               "pairs_held": held.numel(), "tail_held": tail,
               "k_max_abs_err": (kh - kp).abs().max().item(),
               "k_bit_equal": bool(torch.equal(kh, kp)),
               "k_excess_over_tolerance": k_err, "ck_excess_over_tolerance": ck_err,
               "values_only_equal": bool(torch.equal(kv, k)),
               "dz_scaled_err": dz_err, "dz_max_abs_err": (dzh - dzp).abs().max().item(),
               "vs_fp64": {"k": (kh.double() - k64).abs().max().item(),
                           "plain_k": (kp.double() - k64).abs().max().item(),
                           "dz_scaled": scaled_err(dzh, dz64),
                           "plain_dz_scaled": scaled_err(dzp, dz64)},
               "k_range": [k.min().item(), k.max().item()],
               "z_abs_max": z.abs().max().item(),
               "residual_mib": 4 * plan.ck_floats / 2**20,
               "forward_backward_peak_mib": peak_mib, "finite": finite}
        del kp, ckp, dzp, k64, dz64, zh, kh, ckh, dzh
        if name == "flagship_linear_triu":
            if not tail:
                raise AssertionError(f"K5 took {P} pairs in one wave of {plan.resident} "
                                     "blocks: its later waves went unchecked")
            row["plan"] = {"lanes_a_pair": plan.g, "span_template": plan.span,
                           "spans": list(plan.spans),
                           "tile": [plan.tile_rows, plan.tile_cols],
                           "pipeline_steps": {"forward": plan.fwd_steps,
                                              "backward": plan.bwd_steps},
                           "blocks": plan.tiles, "resident_blocks": plan.resident,
                           "waves": plan.waves, "smem_bytes": plan.smem_bytes,
                           "ring_floats_a_group": plan.ring_floats,
                           "scratch_bytes": plan.scratch_bytes,
                           "checkpoint_mib": 4 * plan.ck_floats / 2**20,
                           "traffic_bytes": plan.traffic_bytes,
                           "traffic_bytes_a_pair": {
                               k_: v / P for k_, v in plan.traffic_bytes.items()}}
            row["ptxas"] = {f: r for f, r in ptxas_functions(
                _build.build_all()["sigkernel_tiled"]).items() if "tiled_" in f}
            row["fwd_values_ms"] = event_ms(lambda: kt.tiled_forward(z, with_ck=False), 3)
            row["fwd_ms"] = event_ms(lambda: kt.tiled_forward(z, with_ck=True), 3)
            row["bwd_ms"] = event_ms(lambda: kt.tiled_backward(z, ck, g), 3)
            ckt = kt.twin_checkpoints(ck, lx1, ly1, P)
            del ck
            plain = lambda fn: event_ms(lambda: [  # noqa: E731
                fn(z[..., c0:c0 + 65536], c0) for c0 in range(0, P, 65536)], 1)
            row["plain_fwd_ms"] = plain(lambda zc, c0: kt.tiled_forward_plain(zc, True))
            row["plain_bwd_ms"] = plain(lambda zc, c0: kt.tiled_backward_plain(
                zc, ckt[..., c0:c0 + 65536], g[c0:c0 + 65536]))
            del ckt
            row["fwd_bound"] = bound(kt.tiled_flops(P, lx1, ly1),
                                     kt.tiled_bytes(P, lx1, ly1))
            row["values_bound"] = bound(kt.tiled_flops(P, lx1, ly1),
                                        kt.tiled_bytes(P, lx1, ly1, "values"))
            row["bwd_bound"] = bound(kt.tiled_flops(P, lx1, ly1, "backward"),
                                     kt.tiled_bytes(P, lx1, ly1, "backward"))
            out = row
        emit(row)
        ok = (finite and row["values_only_equal"] and k_err <= 0 and ck_err <= 0
              and dz_err <= dz_tol)
        if not ok:
            raise AssertionError(f"K5 disagrees with its twin: {row}")
        del z, g, k, dz, kv
    return out


def phase_pinned_linear():
    """The pinned order-3 solve on linear statics (bench.py's
    ``ctrl_sig_pinned`` with ``SignatureKernel(3, static="linear")``), as
    ``pinned_solve``: K5's forward and backward launch once per pair chunk
    of each SVGD step's ``gram_and_grad`` (one chunk, asserted), K2,
    K4 and K6 never; then the peak memory of one ``gram_and_grad``."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, calibrate=False,
                         static="linear")
    kern = prob.ctrl.sig_kernel
    if kern.dyadic_order != 3 or kern.static != "linear":
        raise AssertionError(f"the linear pinned controller's kernel is {kern}")
    pairs = prob.ctrl.n_pol * (prob.ctrl.n_pol + 1) // 2
    _, chunk, nb = kern._chunk_plan(39, 39, pairs, 2, torch.device("cuda"), None)
    if nb != 1:
        raise AssertionError(f"the {pairs}-pair linear list was cut in {nb} chunks; "
                             "a quarter of the card holds it whole")
    row = drive_solves("pinned_linear_solve", prob,
                       {"tiled_forward": OPT_STEPS * nb, "tiled_backward": OPT_STEPS * nb},
                       N_SOLVES, sig_gram_stage)
    cs = prob.ctrl.init(generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.no_grad():
        tau = prob.ctrl._tau(prob.ctrl._rollout_costs(prob.q_start, cs.pol_mean)[1])
    _, launches, wall_ms, peak_mib = run_counted(lambda: kern.gram_and_grad(tau))
    emit({"phase": "pinned_linear_solve", "part": "gram_and_grad", "pairs": pairs,
          "chunk": chunk, "chunks": nb, "wall_ms": wall_ms, "launches": launches.counts,
          "peak_allocated_mib": peak_mib})
    launches.expect("pinned_linear gram_and_grad", tiled_forward=nb, tiled_backward=nb)
    return row, tau


def phase_dense_lambda3_gram():
    """``SignatureKernel(3, 4.0).gram(X, Y)`` at [128, 40, 2]² (16,384 pairs,
    below the dense limit) with ``autograd.grad`` with respect to X, on RBF
    and on linear statics: the dense statics, their increments and exactly
    one K5 forward and one backward, no K4; K against the same route with
    the fp32 twin in K5's place (k's tolerance, rtol 2e-5 / atol 1e-6) and
    dX against it with the fp64 twin in the backward's place (scaled 5e-4),
    both on the card; then a [24, 40, 2] × [17, 33, 2] Gram against the
    route on the CPU (K atol 5e-4, as ``test_torch_cuda.py`` holds this
    route's card against its CPU: the two devices' dense statics round
    apart in the last bit and the grid carries it; dX scaled 5e-4). For the
    record, the RBF Gram's n·m pairs through the fused pair-list route,
    K4's forward and backward (``sigkernel_fused.pair_gram_fused``), timed
    the same way."""
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    gen = torch.Generator(device="cuda").manual_seed(16)
    X, Y = smooth_paths(128, 40, 2, gen), smooth_paths(128, 40, 2, gen)
    Xs, Ys = smooth_paths(24, 40, 2, gen), smooth_paths(17, 33, 2, gen)
    rows = {}
    for static in ("rbf", "linear"):
        kern = SignatureKernel(3, 4.0, static=static)

        def run(a=X, b=Y):
            x = a.clone().requires_grad_(True)
            K = kern.gram(x, b)
            (dX,) = torch.autograd.grad(K.sum(), x)
            return K.detach(), dX

        (K, dX), launches, wall_ms, peak_mib = run_counted(run)
        with k5_twins():
            Kp, _ = run()
        with k5_twins(torch.float64):
            _, dX64 = run()
        Kc, dXc = run(Xs, Ys)
        Kcpu, dXcpu = run(Xs.cpu(), Ys.cpu())
        k_err = k_excess(K, Kp, K5_TOL[0])
        dx_err = scaled_err(dX, dX64)
        cpu = {"k_abs": (Kc.cpu() - Kcpu).abs().max().item(),
               "dx_scaled": scaled_err(dXc.cpu(), dXcpu)}
        finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
        row = {"phase": "dense_lambda3_gram", "static": static,
               "shape": [[128, 40, 2], [128, 40, 2]], "pairs": 128 * 128,
               "wall_ms": wall_ms, "launches": launches.counts, "peak_allocated_mib": peak_mib,
               "k_max_abs_err": (K - Kp).abs().max().item(), "k_excess_over_tolerance": k_err,
               "dx_scaled_err_vs_fp64": dx_err, "vs_cpu_24x17": cpu,
               "k_range": [K.min().item(), K.max().item()], "finite": finite}
        if static == "rbf":
            idx = torch.arange(128 * 128, device="cuda")

            def k4_route():
                x = X.clone().requires_grad_(True)
                K4 = kf.pair_gram_fused(x, Y, idx // 128, idx % 128, 4.0).reshape(128, 128)
                (dX4,) = torch.autograd.grad(K4.sum(), x)
                return K4.detach(), dX4

            K4, dX4 = k4_route()
            row["k4_route"] = {"wall_ms": host_ms(k4_route, 3), "k5_route_wall_ms": host_ms(run, 3),
                               "k_max_abs_diff": (K4 - K).abs().max().item(),
                               "dx_scaled_diff": scaled_err(dX4, dX)}
        emit(row)
        launches.expect(f"dense_lambda3_gram {static}", tiled_forward=1, tiled_backward=1)
        if not (finite and k_err <= 0 and dx_err <= K5_TOL[1] and cpu["k_abs"] <= 5e-4
                and cpu["dx_scaled"] <= K5_TOL[1]):
            raise AssertionError(f"dense_lambda3_gram disagrees with its twins: {row}")
        rows[static] = row
    return rows


def phase_c12_pair_list():
    """λ=3 ``gram_and_grad`` at [256, 17, 12] (RBF statics, 32,896 pairs;
    12 channels are outside the fused kernels and K2): one K5 forward and
    one backward on increments built in torch, nothing else; wall time and
    peak memory; K and dX against the same route with the twins in K5's
    place (the fp32 forward, K atol 1e-4; the fp64 backward, dX scaled
    5e-4)."""
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    gen = torch.Generator(device="cuda").manual_seed(17)
    X = smooth_paths(256, 17, 12, gen)
    kern = SignatureKernel(3, 4.0)
    (K, dX), launches, wall_ms, peak_mib = run_counted(lambda: kern.gram_and_grad(X))
    with k5_twins(torch.float64):
        Kp, dXp = kern.gram_and_grad(X)
    k_err = (K - Kp).abs().max().item()
    dx_err = scaled_err(dX, dXp)
    row = {"phase": "c12_pair_list", "shape": [256, 17, 12], "pairs": 256 * 257 // 2,
           "wall_ms": wall_ms, "launches": launches.counts, "peak_allocated_mib": peak_mib,
           "k_max_abs_err": k_err, "dx_scaled_err_vs_fp64": dx_err,
           "k_range": [K.min().item(), K.max().item()],
           "finite": bool(torch.isfinite(K).all() and torch.isfinite(dX).all())}
    emit(row)
    launches.expect("c12_pair_list", tiled_forward=1, tiled_backward=1)
    if not (row["finite"] and k_err <= K4_TOL[0] and dx_err <= K5_TOL[1]):
        raise AssertionError(f"c12_pair_list disagrees with its twins: {row}")
    return row


def phase_linear_streamed_gram(X, Y):
    """The linear ``gram(X, Y)`` on τ of two flagship rollouts, [1024, 40, 2]
    × [1024, 40, 2] (1,048,576 pairs, above the dense limit), with its
    gradient with respect to X: the Gram each device of the JAX package's
    column-sharded solve computes, here on linear statics. Checkpointed
    chunks: two K5 forwards and one backward per chunk (the plan is
    reported), nothing else; wall time and peak memory; rows 0..15 and
    1008..1023 held against the same streamed route on those rows with the
    twins in K5's place (the fp32 forward for K, k's tolerance rtol 2e-5 /
    atol 1e-6; the fp64 backward for dX, scaled 5e-4)."""
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    kern = SignatureKernel(3, static="linear")
    n, m = X.shape[0], Y.shape[0]

    def run():
        x = X.clone().requires_grad_(True)
        K = kern.gram(x, Y)
        (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach(), dX

    (K, dX), launches, wall_ms, peak_mib = run_counted(run)
    _, chunk, nb = kern._chunk_plan(39, 39, n * m, 2, X.device, None)
    rows = torch.cat([torch.arange(16), torch.arange(n - 16, n)]).cuda()
    x = X[rows].clone().requires_grad_(True)
    with k5_twins(torch.float64):
        Kp = kern._gram_chunked_pairs(x, Y)
        (dXp,) = torch.autograd.grad(Kp.sum(), x)
    k_err = k_excess(K[rows], Kp.detach(), K5_TOL[0])
    dx_err = scaled_err(dX[rows], dXp)
    row = {"phase": "linear_streamed_gram", "shape": [list(X.shape), list(Y.shape)],
           "pairs": n * m, "chunk": chunk, "chunks": nb, "wall_ms": wall_ms,
           "launches": launches.counts, "peak_allocated_mib": peak_mib,
           "rows_held": [[0, 15], [n - 16, n - 1]],
           "k_max_abs_err": (K[rows] - Kp.detach()).abs().max().item(),
           "k_excess_over_tolerance": k_err,
           "dx_scaled_err_vs_fp64": dx_err, "k_range": [K.min().item(), K.max().item()],
           "finite": bool(torch.isfinite(K).all() and torch.isfinite(dX).all())}
    emit(row)
    launches.expect("linear_streamed_gram", tiled_forward=2 * nb, tiled_backward=nb)
    if not (row["finite"] and K.shape == (n, m) and k_err <= 0 and dx_err <= K5_TOL[1]):
        raise AssertionError(f"linear_streamed_gram disagrees with its twins: {row}")
    return row


def tiled_entry(name, replaces, k5, launches, which) -> dict:
    """A K5 entry at the flagship linear list (524,800 pairs of τ [1024, 40,
    2]), the list the pinned linear solve's ``gram_and_grad`` runs;
    ``launches`` from that solve's run and by path. No PyTorch call
    computes the sweep, so ``library_ms`` is null."""
    b = k5[f"{which}_bound"]
    entry = {"name": name, "route": "cuda", "source": "sigsvgd_tpu_torch/csrc/sigkernel_tiled.cu",
             "replaces": replaces, "shape": k5["shape"], "pairs": k5["pairs"],
             "launches": launches["pinned_linear_solve"], "launches_by_path": launches,
             "max_abs_err": k5["k_max_abs_err" if which == "fwd" else "dz_max_abs_err"],
             "ms": k5[f"{which}_ms"], "plain_ms": k5[f"plain_{which}_ms"],
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}
    if which == "fwd":
        entry["values_only_ms"] = k5["fwd_values_ms"]
    return entry


def path_shape(row, which) -> dict:
    """A kernel's times, error and bound at the shape a planning path gives
    it (``which``: the forward's or the backward's)."""
    pre = "" if which == "fwd" else "bwd_"
    err = row["max_abs_err"] if which == "fwd" else row.get(
        "dz_max_abs_err", row.get("dX_max_abs_err_vs_fp64"))
    return {"shape": row["shape"], "ms": row[f"{pre}ms" if pre else "kernel_ms"],
            "plain_ms": row[f"plain_{pre}ms" if pre else "plain_ms"],
            "bound_ms": row[f"{pre}bound_ms"], "bound_by": row[f"{pre}bound_by"],
            "library_ms": None, "max_abs_err": err}


def lbfgs_k8(rows: dict, which: str) -> dict:
    """K8's launches on the L-BFGS and mesh process's paths."""
    return {"planning_lbfgs": rows["planning_lbfgs"]["launches"][which],
            "planning_lbfgs_resume": {stage: counts.get(which, 0) for stage, counts in
                                      rows["planning_lbfgs_resume"]["launches"].items()},
            "mesh_scene": rows["mesh_scene"]["launches"][which]}


def shard_launches(row) -> dict:
    """A sharded solve's launches of its block kernel, rank by rank."""
    return {f"{row['phase']} {tag} rank {r}": rr["launches"]
            for tag in (k for k in row if k.startswith(("nccl", "gloo")))
            for r, rr in enumerate(row[tag]["per_rank"])}


def parallel_k8(rows: dict, which: str) -> dict:
    """K8's launches on the parallel process's paths."""
    return {"mxu_pair_gram_and_grad": rows["mxu_pair_gram_and_grad"]["launches"][which],
            "planning_iter_4096":
                rows["mxu_pair_gram_and_grad"]["planning_iter_4096"]["launches"][which],
            "streamed_mxu_gram": rows["streamed_mxu_gram"]["launches"][which],
            **{f"sharded_planning rank {r}": c[which]
               for r, c in enumerate(rows["sharded_planning"]["launches_per_rank"])}}


def kernel_entry(name, source, replaces, launches, row) -> dict:
    """One kernel's entry; its times, error and bound are all at ``shape``."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": row["shape"],
            "launches": launches, "max_abs_err": row["k_max_abs_err"]
            if "k_max_abs_err" in row else row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def k8_entry(name, replaces, launches, row, which) -> dict:
    """A K8 entry at the planning shape; ``launches`` from ``planning_iter``.
    No single PyTorch call computes the chain, so ``library_ms`` is null;
    the fp32 block propagator's forward + backward time is the reference."""
    b = row[f"{which}_bound"]
    return {"name": name, "route": "cuda", "source": "sigsvgd_tpu_torch/csrc/mxu_chain.cu",
            "replaces": replaces, "shape": row["shape"], "launches": launches,
            "max_abs_err": row["k_max_abs_err" if which == "fwd" else "dz_max_abs_err"],
            "ms": row[f"{which}_ms"], "plain_ms": row[f"plain_{which}_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "reference_fp32_route_fwd_bwd_ms": row["fp32_route_fwd_bwd_ms"]}


def fused_entry(name, replaces, launches, row, which, by_path) -> dict:
    """A K4 entry at the flagship pair list; ``launches`` from the path that
    runs it (the bf16 pinned solve for the forward, the streamed Gram for
    the backward). No PyTorch call computes the sweep, so ``library_ms`` is
    null."""
    b = row[f"{which}_bound"]
    return {"name": name, "route": "cuda", "source": "sigsvgd_tpu_torch/csrc/sigkernel_fused.cu",
            "replaces": replaces, "shape": row["shape"], "pairs": row["pairs"],
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": row["k_max_abs_err" if which == "fwd" else "dX_max_abs_err_vs_fp64"],
            "ms": row[f"{which}_ms"], "plain_ms": row[f"plain_{which}_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}


def small_entry(name, replaces, streamed, k7, gg0, counter, par=None) -> dict:
    """A K7 entry at the streamed λ=0 Gram's pair list (1,048,576 pairs of
    [40, 2] τ paths), the main path that launches it: its launches there, and
    by path; its times, the twin's and the bound at that list (the forward
    with its residual, as the gradient's run takes it; the values-only time
    beside it); the error against the twin on the held rows. The flagship
    triangle list's times are in ``k7_vs_plain``. No PyTorch call computes
    the sweep, so ``library_ms`` is null."""
    t = streamed["k7_at_this_list"]
    which = "fwd_res" if counter == "small_forward" else "bwd"
    entry = {"name": name, "route": "cuda", "source": "sigsvgd_tpu_torch/csrc/sigkernel_small.cu",
             "replaces": replaces, "shape": streamed["shape"], "pairs": streamed["pairs"],
             "launches": streamed["launches"][counter],
             "launches_by_path": {"lambda0_streamed_gram": streamed["launches"][counter],
                                  **{f"lambda0_gram_and_grad {c}": r["launches"][counter]
                                     for c, r in gg0.items()},
                                  **({f"sharded_modes {m} rank {r}": c[counter]
                                      for m in ("gather", "ring")
                                      for r, c in enumerate(par[m]["launches_per_rank"])}
                                     if par else {})},
             "max_abs_err": streamed["k_max_abs_err" if which == "fwd_res"
                                     else "dx_max_abs_err"],
             "ms": t[f"{which}_ms"], "plain_ms": t[f"plain_{which}_ms"],
             "bound_ms": t[f"{which}_bound"]["bound_ms"],
             "bound_by": t[f"{which}_bound"]["bound_by"], "library_ms": None,
             "flagship_triu_ms": k7[f"{which}_ms"]}
    if which == "fwd_res":
        entry["values_only_ms"] = t["fwd_ms"]
    return entry


# ---------------------------------------------------------------------------
# The parallel process (``chip_smoke.py --parallel``): the block
# propagator's pair lists, K1 and K2 on tile subsets, and the sharded
# solvers on torch.distributed, on 1 rank with NCCL and on 2 ranks sharing
# the card with gloo (``chip_smoke.py --parallel-rank``).
# ---------------------------------------------------------------------------

SHARD_TOL = (2e-3, 2e-4)  # rtol, atol, sharded against one rank (tests/test_parallel_dust.py)
MODES_TOL = (1e-4, 1e-5)  # the gather and ring modes against triangle (the same test file)
SVGD_TOL = (1e-3, 1e-4)   # the sharded planning run against SVGD.run (tests/test_parallel.py)
MPF_TOL = (1e-4, 1e-5)    # the sharded MPF against MPF.observe (tests/test_parallel_mpf.py)
SHARD_RANKS = 2
SHARD_SOLVES = 3          # timed solves a sharded phase, after the compared first one
ADAM_BEYOND_SHARE = 1e-4  # of the λ=3 Adam solve's policy coordinates, each within 2·lr
PLAN_SHARD_STEPS = 5      # sharded_planning's SVGD steps
MXU_PAIRS_N = 4096        # mxu_pair_gram_and_grad's knots: 8,390,656 triangle pairs
MXU_STREAM_N = 8192       # streamed_mxu_gram's knots on both sides: n·m·L² = 6.0e8
MXU_SAMPLE = 4096         # pairs held against the fp32 propagator
_CARD = []


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if not _CARD:
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return _CARD[0]


def phase_parallel() -> dict:
    """The pair lists and the sharded solvers, in a fresh process
    (``chip_smoke.py --parallel``, :func:`parallel_phases`), which starts the
    ranks. Its rows, by phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--parallel"], capture_output=True,
                          text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            rows.setdefault(row["phase"], row)
            emit(row)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise AssertionError(f"the parallel process failed (exit {proc.returncode})")
    want = {"mxu_pair_gram_and_grad", "streamed_mxu_gram", "tile_subsets_vs_plain",
            "sharded_flagship_solve", "sharded_pinned_solve", "sharded_modes",
            "sharded_planning", "sharded_mpf", "collectives"}
    if set(rows) != want:
        raise AssertionError(f"the parallel process gave the phases {sorted(rows)}")
    emit({"phase": "parallel_process", "wall_s": wall_s, "card": card()})
    return rows


def scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def sampled_pairs(n: int, m: int, count: int, gen: torch.Generator, triangle: bool):
    """``count`` random pairs (a ≤ b with ``triangle``) on the card."""
    a = torch.randint(0, n, (count,), generator=gen, device="cuda")
    b = torch.randint(0, m, (count,), generator=gen, device="cuda")
    if triangle:
        a, b = torch.minimum(a, b), torch.maximum(a, b)
    return a, b


def k8_chunk_vs_twin(kern, X, a, b, h) -> dict:
    """One pair-list chunk's values and their gradient by K8 on the card and
    by its twin on the CPU (``SignatureKernel._block_values``)."""
    out = {}
    for dev in ("cuda", "cpu"):
        x = X.to(dev).detach().requires_grad_(True)
        with torch.enable_grad():
            k = kern._block_values(x, x, a.to(dev), b.to(dev), h, "mxu_chain")
            (d,) = torch.autograd.grad(k.sum(), x)
        out[dev] = (k.detach().cpu(), d.cpu())
    return {"chunk_pairs": int(a.shape[0]),
            "chunk_k_scaled_err": scaled(out["cuda"][0], out["cpu"][0]),
            "chunk_dx_scaled_err": scaled(out["cuda"][1], out["cpu"][1])}


def phase_mxu_pair_gram_and_grad() -> None:
    """``gram_and_grad`` on [4096, 3, 7] knots at λ=6 with K8
    (``mxu_precision="default"``), above the dense route's memory guard: the
    triangle pair list, K8's forward and backward once a chunk. K on sampled
    pairs against the fp32 propagator's pair list (K8's tolerance against
    it), one chunk of pairs against K8's twin, then one planning iteration
    at 4,096 knots (``PlannerConfig()`` otherwise) on the same route."""
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    cfg = PlannerConfig()
    h = cfg.pathsig_bw
    kern = SignatureKernel(dyadic_order=cfg.depth, bandwidth=h, mxu_precision="default")
    n = MXU_PAIRS_N
    gen = torch.Generator(device="cuda").manual_seed(21)
    X = uniform_knots(n, gen)
    if kern._dense_grad_ok(n, 2) or kern._solver_kind(2, 2) != "mxu_chain":
        raise AssertionError("mxu_pair_gram_and_grad: not the K8 pair-list route")
    pairs = n * (n + 1) // 2
    kind, chunk, nb = kern._chunk_plan(2, 2, pairs, 7, X.device, h)
    kern.gram_and_grad(X)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Launches() as counted:
        t0 = time.perf_counter()
        K, dX = kern.gram_and_grad(X)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counted.expect("mxu_pair_gram_and_grad", mxu_chain_fwd=nb, mxu_chain_bwd=nb)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    a, b = sampled_pairs(n, n, MXU_SAMPLE, gen, True)
    fp32 = SignatureKernel(dyadic_order=cfg.depth, bandwidth=h, solver="mxu")
    with torch.no_grad():
        ref = fp32._pair_values(X, X, a, b, h)
    k_err = scaled(K[a, b], ref)
    if not (k_err <= K8_FP32_TOL[0] and bool(torch.isfinite(dX).all())
            and torch.equal(K, K.T)):
        raise AssertionError(f"mxu_pair_gram_and_grad: K {k_err} from the fp32 propagator")
    twin = k8_chunk_vs_twin(kern, X, a[:1024], b[:1024], h)
    if twin["chunk_k_scaled_err"] > K8_TOL[0] or twin["chunk_dx_scaled_err"] > K8_TOL[1]:
        raise AssertionError(f"mxu_pair_gram_and_grad: the chunk against K8's twin {twin}")
    del K, dX

    problem, pcfg, svgd, score = planning_setup(n)
    x = uniform_knots(n, torch.Generator(device="cuda").manual_seed(2))
    st = svgd.init(x)
    x, st = svgd.step_update(x, st, score(x, None))  # warm-up
    torch.cuda.synchronize()
    with Launches() as it:
        t0 = time.perf_counter()
        x, st = svgd.step_update(x, st, score(x, None))
        torch.cuda.synchronize()
        iter_ms = (time.perf_counter() - t0) * 1e3
    it.expect("planning iteration at 4096 knots", mxu_chain_fwd=nb, mxu_chain_bwd=nb)
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("mxu_pair_gram_and_grad: the planning iteration is not finite")
    emit({"phase": "mxu_pair_gram_and_grad", "card": card(), "shape": [n, 3, 7],
          "dyadic_order": cfg.depth, "pairs": pairs, "kind": kind, "chunk": chunk,
          "chunks": nb, "ms": ms, "peak_mib_above_inputs": peak_mib,
          "launches": counted.counts, "k_scaled_err_vs_fp32_propagator": k_err,
          "sampled_pairs": MXU_SAMPLE, **twin,
          "planning_iter_4096": {"ms": iter_ms, "launches": it.counts,
                                 "batch": n, "timesteps": pcfg.timesteps}})


def phase_streamed_mxu_gram() -> None:
    """``gram(X, Y)`` on [8192, 3, 7] × [8192, 3, 7] (n·m·L² = 6.0e8 >
    2e8: streamed pair chunks through K8) with its gradient in X: each
    chunk's K8 forward twice (the checkpointed chunk reruns it) and its
    backward once. K on sampled pairs against the fp32 propagator."""
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

    cfg = PlannerConfig()
    h = cfg.pathsig_bw
    kern = SignatureKernel(dyadic_order=cfg.depth, bandwidth=h, mxu_precision="default")
    n = MXU_STREAM_N
    gen = torch.Generator(device="cuda").manual_seed(22)
    X, Y = uniform_knots(n, gen), uniform_knots(n, gen)
    if n * n * 9 <= kern._DENSE_LIMIT:
        raise AssertionError("streamed_mxu_gram: below the dense limit")
    kind, chunk, nb = kern._chunk_plan(2, 2, n * n, 7, X.device, h)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Launches() as counted:
        t0 = time.perf_counter()
        x = X.detach().requires_grad_(True)
        K = kern.gram(x, Y)
        (dX,) = torch.autograd.grad(K.sum(), x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counted.expect("streamed_mxu_gram", mxu_chain_fwd=2 * nb, mxu_chain_bwd=nb)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    a, b = sampled_pairs(n, n, MXU_SAMPLE, gen, False)
    fp32 = SignatureKernel(dyadic_order=cfg.depth, bandwidth=h, solver="mxu")
    with torch.no_grad():
        ref = fp32._pair_values(X, Y, a, b, h)
    k_err = scaled(K.detach()[a, b], ref)
    if not (k_err <= K8_FP32_TOL[0] and bool(torch.isfinite(dX).all())):
        raise AssertionError(f"streamed_mxu_gram: K {k_err} from the fp32 propagator")
    emit({"phase": "streamed_mxu_gram", "card": card(), "shape": [n, 3, 7],
          "pairs": n * n, "kind": kind, "chunk": chunk, "chunks": nb, "ms_fwd_bwd": ms,
          "peak_mib_above_inputs": peak_mib, "launches": counted.counts,
          "k_scaled_err_vs_fp32_propagator": k_err, "sampled_pairs": MXU_SAMPLE})


def phase_tile_subsets_vs_plain() -> None:
    """K1 at [1024, 40, 2] and K2 at [128, 40, 2] over each of 2 ranks' tile
    subsets against their twins on the subsets' pairs (K1's K bit for bit,
    dX scaled 5e-5; K2's K atol 1e-4, dX scaled 4e-4 against the fp64
    twin); the subsets summed against the whole launch; times of a subset
    launch beside the whole."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3

    gen = torch.Generator(device="cuda").manual_seed(23)
    row = {"phase": "tile_subsets_vs_plain", "card": card(), "ranks": SHARD_RANKS}
    for name, fn, n in (("k1", kb.block_gram_and_grad, 1024),
                        ("k2", kb3.block3_gram_and_grad, 128)):
        X = smooth_paths(n, 40, 2, gen)
        tc = kb.THREADS // kb.block_lanes(40)[0]
        tiles = kb._tile_list(n, tc, X.device)
        K_all, dX_all = fn(X, 4.0)
        K_sum, dX_sum, per_rank = torch.zeros_like(K_all), torch.zeros_like(dX_all), []
        for r in range(SHARD_RANKS):
            K, dX = fn(X, 4.0, shard=(SHARD_RANKS, r))
            pairs = kb.tile_pairs(kb.tile_shard(tiles, SHARD_RANKS, r), n, tc)
            if name == "k1":
                Kp, dXp = kb.block_gram_and_grad_plain(X, 4.0, pairs=pairs)
                ok = torch.equal(K, Kp) and scaled(dX, dXp) <= 5e-5
                k_err, dx_err = (K - Kp).abs().max().item(), scaled(dX, dXp)
            else:
                Kp, _ = kb3.block3_gram_and_grad_plain(X, 4.0, pairs_per_chunk=2048,
                                                       pairs=pairs)
                _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 4.0,
                                                         pairs_per_chunk=2048, pairs=pairs)
                k_err, dx_err = (K - Kp).abs().max().item(), scaled(dX.double(), dX64)
                ok = k_err <= K2_TOL[0] and dx_err <= K2_TOL[1]
            if not ok:
                raise AssertionError(f"tile_subsets_vs_plain: {name} rank {r}: K {k_err}, "
                                     f"dX {dx_err}")
            K_sum += K
            dX_sum += dX
            per_rank.append({"tiles": int(kb.tile_shard(tiles, SHARD_RANKS, r).shape[0]),
                             "pairs": int(pairs[0].numel()), "k_max_abs_err": k_err,
                             "dx_scaled_err": dx_err,
                             "ms": event_ms(lambda r=r: fn(X, 4.0, shard=(SHARD_RANKS, r)),
                                            3)})
        sum_err = (torch.equal(K_sum, K_all), scaled(dX_sum, dX_all))
        if not sum_err[0] or sum_err[1] > 1e-6:
            raise AssertionError(f"tile_subsets_vs_plain: {name}: the subsets' sum {sum_err}")
        row[name] = {"shape": [n, 40, 2], "tiles": int(tiles.shape[0]), "per_rank": per_rank,
                     "whole_ms": event_ms(lambda: fn(X, 4.0), 3),
                     "dx_sum_scaled_err": sum_err[1]}
    emit(row)


def local_state(cs, n_total: int, mesh):
    """The rows of a DuSt state this rank holds."""
    from sigsvgd_tpu_torch.parallel.mesh import local_rows

    def rows(t):
        return local_rows(t, mesh) if (isinstance(t, torch.Tensor) and t.ndim >= 1
                                       and t.shape[0] == n_total) else t

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(c) for c in node)
        return rows(node)

    return walk(cs)


def raw_lr(ctrl):
    """The controller with the raw lr update (0.05): Adam's first steps move
    each coordinate by ±lr whatever its gradient's size, so a gradient that
    fp summation order moves across zero moves its coordinate by up to 2·lr;
    the JAX package's sharded identity tests compare raw-lr solves for this
    reason (``tests/test_parallel_dust.py``)."""
    return dataclasses.replace(ctrl, optimizer=None, lr=0.05)


def sharded_solves(phase: str, prob, mesh, gram_mode: str = "triangle",
                   timed: int = SHARD_SOLVES) -> dict:
    """The first sharded solve from the seeded initial policies with the
    raw lr update and with Adam (their actions and gathered policies kept),
    then ``timed`` chained Adam solves with every hand kernel's launches
    counted on this rank."""
    import torch.distributed as dist
    from sigsvgd_tpu_torch.parallel import comm
    from sigsvgd_tpu_torch.parallel.dust import sharded_dust_forward

    state = prob.q_start
    out = {}
    for tag, ctrl in (("raw", raw_lr(prob.ctrl)), ("adam", prob.ctrl)):
        cs = local_state(ctrl.init(generator=torch.Generator(device="cuda").manual_seed(1)),
                         ctrl.n_total, mesh)
        a, cs = sharded_dust_forward(ctrl, state, cs, None, OPT_STEPS, mesh,
                                     gram_mode=gram_mode)
        out[tag] = {"a_seq": a.cpu(), "pol_mean": comm.all_gather(cs.pol_mean).cpu()}
    ms = []
    with Launches() as counted:
        for _ in range(timed):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, cs = sharded_dust_forward(ctrl, state, cs, None, OPT_STEPS, mesh,
                                         gram_mode=gram_mode)
            state = prob.model.step(state[None], a[0:1])[0]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out.update(ms=ms, launches=counted.counts,
               finite=bool(torch.isfinite(a).all() and torch.isfinite(cs.pol_mean).all()))
    return out


def single_solves(prob, timed: int = SHARD_SOLVES) -> dict:
    """The same first solves and timed chained solves on one device, no
    process group."""
    state = prob.q_start
    out = {}
    for tag, ctrl in (("raw", raw_lr(prob.ctrl)), ("adam", prob.ctrl)):
        cs = ctrl.init(generator=torch.Generator(device="cuda").manual_seed(1))
        a, cs, _ = ctrl.forward(state, cs, opt_steps=OPT_STEPS)
        out[tag] = {"a_seq": a.cpu(), "pol_mean": cs.pol_mean.cpu()}
    out["adam_lr"] = float(prob.ctrl.optimizer.lr)
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, cs, _ = ctrl.forward(state, cs, opt_steps=OPT_STEPS)
        state = prob.model.step(state[None], a[0:1])[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = ms
    return out


def shard_problems():
    """The flagship (calibrated λ=0: K1) and pinned (λ=3 fp32: K2) problems."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc

    flag = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40)
    pinned = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40, calibrate=False)
    if (flag.ctrl.sig_kernel.dyadic_order, pinned.ctrl.sig_kernel.dyadic_order) != (0, 3):
        raise AssertionError("the sharded phases' problems are not at orders 0 and 3")
    return {"flagship": flag, "pinned": pinned}


def planning_start():
    problem, cfg, svgd, score = planning_setup(1024)
    x0 = uniform_knots(1024, torch.Generator(device="cuda").manual_seed(2))
    return problem, cfg, svgd, score, x0


def mpf_start():
    """The maze's MPF (``MazeConfig()``: 50 particles in log space) before
    one observe-update, and the transition it observes."""
    from sigsvgd_tpu_torch.experiments import maze

    cfg = maze.MazeConfig()
    model = maze.make_model(cfg, "cuda")
    mpf = maze.build_mpf(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(5)
    masses = cfg.dyn_prior_mean + cfg.dyn_prior_std * torch.randn(
        (cfg.mpf_n_particles, 1), generator=g, device="cuda")
    state = torch.tensor(model.init_state, dtype=torch.float32, device="cuda")
    action = torch.tensor([1.0, -0.5], device="cuda")
    nxt = model.step(state[None], action[None])[0]
    return cfg, mpf, mpf.init(torch.log(masses), state), action, nxt


def pendulum_policy_ctrl():
    """``tests/test_parallel_scaling.py``'s policy-mode controller on the card."""
    from sigsvgd_tpu_torch.controllers.dust import DuSt
    from sigsvgd_tpu_torch.inference.svgd import Adam
    from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
    from sigsvgd_tpu_torch.models.pendulum import PendulumModel

    model = PendulumModel(dt=0.05)
    ctrl = DuSt(model=model, hz_len=10, n_pol=16, device="cuda", kernel_mode="policy",
                kernel=GaussianKernel(), optimizer=Adam(0.1),
                inst_cost_fn=model.swingup_inst_cost, term_cost_fn=model.swingup_term_cost)
    return ctrl, torch.tensor([math.pi, 0.0], device="cuda")


def rank_phases(world: int, results: dict, probs: dict) -> None:
    """Every sharded phase on this rank of an initialised group of
    ``world`` (the mesh on the card)."""
    import torch.distributed as dist
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
    from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel
    from sigsvgd_tpu_torch.parallel import comm
    from sigsvgd_tpu_torch.parallel.dust import sharded_dust_forward
    from sigsvgd_tpu_torch.parallel.mesh import local_rows, make_mesh
    from sigsvgd_tpu_torch.parallel.mpf import sharded_mpf_observe
    from sigsvgd_tpu_torch.parallel.scaling import collective_stats
    from sigsvgd_tpu_torch.parallel.svgd import sharded_pathsig_score, sharded_svgd_run

    rank = dist.get_rank()
    mesh = make_mesh([world], ("dp",))
    tc = kb.THREADS // kb.block_lanes(40)[0]
    tiles = int(kb.tile_shard(kb._tile_list(1024, tc, "cuda"), world, rank).shape[0])
    for name, prob in probs.items():
        results[name] = dict(sharded_solves(name, prob, mesh), tiles=tiles)
    if world > 1:
        results["modes"] = {m: sharded_solves("modes", probs["flagship"], mesh, m, timed=1)
                            for m in ("gather", "ring")}
        problem, cfg, svgd, _, x0 = planning_start()
        kern = SignatureKernel(dyadic_order=cfg.depth, bandwidth=cfg.pathsig_bw,
                               mxu_precision=cfg.mxu_precision)
        score = sharded_pathsig_score(problem.batch_cost, kern, mesh)
        dist.barrier()
        with Launches() as counted:
            t0 = time.perf_counter()
            x, losses = sharded_svgd_run(svgd, local_rows(x0, mesh), score, PLAN_SHARD_STEPS,
                                         mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / PLAN_SHARD_STEPS
        results["planning"] = {"x": comm.all_gather(x).cpu(), "ms_per_iter": ms,
                               "launches": counted.counts}
        cfg_m, mpf, mstate, action, nxt = mpf_start()
        local = mstate._replace(particles=local_rows(mstate.particles, mesh))
        new, grads = sharded_mpf_observe(mpf, local, action, nxt, mesh, n_steps=cfg_m.mpf_steps)
        results["mpf"] = {"particles": comm.all_gather(new.particles).cpu(),
                          "grads": grads.cpu()}
        ctrl, state = pendulum_policy_ctrl()
        cs = local_state(ctrl.init(generator=torch.Generator(device="cuda").manual_seed(0)),
                         ctrl.n_total, mesh)
        results["collectives"] = collective_stats(sharded_dust_forward, ctrl, state, cs,
                                                  None, 2, mesh)
        results["transport"] = comm.transport_report()


def parallel_rank() -> None:
    """``chip_smoke.py --parallel-rank RANK WORLD DIR``: one rank of the
    gloo group of ``WORLD`` ranks sharing the card (rendezvous through a
    ``FileStore`` in ``DIR``); its results go to ``DIR/rank{RANK}.pt``."""
    import torch.distributed as dist

    rank, world, d = int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), world),
                            rank=rank, world_size=world)
    results = {}
    rank_phases(world, results, shard_problems())
    torch.save(results, d / f"rank{rank}.pt")
    dist.destroy_process_group()


def close(got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """The largest excess of ``|got - want|`` over ``atol + rtol·|want|``
    (≤ 0 when within the tolerance)."""
    return ((got - want).abs() - (tol[1] + tol[0] * want.abs())).max().item()


def parallel_phases() -> None:
    """The parallel process: the pair lists, the tile subsets, the
    single-device references, the sharded solves on 1 rank with NCCL (in
    this process), then on 2 ranks sharing the card with gloo (two fresh
    processes), each held against the references."""
    import torch.distributed as dist

    phase_mxu_pair_gram_and_grad()
    phase_streamed_mxu_gram()
    phase_tile_subsets_vs_plain()

    probs = shard_problems()
    single = {name: single_solves(prob) for name, prob in probs.items()}
    problem, cfg, svgd, score, x0 = planning_start()
    t0 = time.perf_counter()
    x_single = svgd.run(x0, score, PLAN_SHARD_STEPS)[0]
    torch.cuda.synchronize()
    plan_single_ms = (time.perf_counter() - t0) * 1e3 / PLAN_SHARD_STEPS
    cfg_m, mpf, mstate, action, nxt = mpf_start()
    mpf_single, grads_single = mpf.observe(mstate, action, nxt, n_steps=cfg_m.mpf_steps)
    del problem, svgd, score

    tmp = Path(tempfile.mkdtemp(prefix="shard_"))
    one = {}
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        rank_phases(1, one, probs)
    finally:
        dist.destroy_process_group()
    del probs
    torch.cuda.empty_cache()

    env = dict(__import__("os").environ)
    procs = [subprocess.Popen([sys.executable, __file__, "--parallel-rank", str(r),
                               str(SHARD_RANKS), str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(SHARD_RANKS)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        sys.stderr.write("\n".join(e[-3000:] for e in errs))
        raise AssertionError(f"the ranks failed (exit {[p.returncode for p in procs]})")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(SHARD_RANKS)]

    kb_counter = {"flagship": "block_gram_and_grad", "pinned": "block3_gram_and_grad"}
    for name, phase in (("flagship", "sharded_flagship_solve"),
                        ("pinned", "sharded_pinned_solve")):
        ref = single[name]
        row = {"phase": phase, "card": card(), "n_pol": 1024, "hz_len": 40,
               "opt_steps": OPT_STEPS, "gram_mode": "triangle",
               "unsharded_ms_median": statistics.median(ref["ms"])}
        for tag, res in [("nccl_1_rank", [one[name]])] + [
                (f"gloo_{SHARD_RANKS}_ranks", [r[name] for r in ranks])]:
            errs_ = [close(res[0]["raw"][k], ref["raw"][k], SHARD_TOL)
                     for k in ("a_seq", "pol_mean")]
            adam = [close(res[0]["adam"][k], ref["adam"][k], SHARD_TOL)
                    for k in ("a_seq", "pol_mean")]
            pol_got, pol_want = res[0]["adam"]["pol_mean"], ref["adam"]["pol_mean"]
            beyond = int(((pol_got - pol_want).abs()
                          > SHARD_TOL[1] + SHARD_TOL[0] * pol_want.abs()).sum())
            for r, rr in enumerate(res):
                want = {k: 0 for k in rr["launches"]}
                want[kb_counter[name]] = OPT_STEPS * SHARD_SOLVES
                if rr["launches"] != want or not rr["finite"]:
                    raise AssertionError(f"{phase} {tag} rank {r}: launches {rr['launches']}")
            # the raw-lr solve and the Adam solve's actions are held at the
            # tolerance, and so are the Adam policies at λ=0; at λ=3 at most
            # ADAM_BEYOND_SHARE of their coordinates may pass it (a gradient
            # near zero that summation order flips), each by at most 2·lr
            adam_ok = (max(adam) <= 0 if name == "flagship" else
                       adam[0] <= 0 and beyond <= ADAM_BEYOND_SHARE * pol_want.numel()
                       and adam[1] <= 2 * ref["adam_lr"])
            if max(errs_) > 0 or not adam_ok:
                raise AssertionError(f"{phase} {tag}: raw lr {errs_}, Adam {adam} "
                                     f"beyond {SHARD_TOL} ({beyond} policy coordinates)")
            row[tag] = {"ms_median": statistics.median(res[0]["ms"]),
                        "ms_samples": res[0]["ms"],
                        "excess_over_tol": errs_, "adam_excess_over_tol": adam,
                        "adam_pol_coords_beyond_tol": beyond,
                        "per_rank": [{"launches": rr["launches"][kb_counter[name]],
                                      "tiles": rr["tiles"]} for rr in res]}
        emit(row)

    row = {"phase": "sharded_modes", "card": card(), "ranks": SHARD_RANKS}
    tri = ranks[0]["flagship"]
    for mode in ("gather", "ring"):
        res = ranks[0]["modes"][mode]
        errs_ = [close(res["raw"][k], tri["raw"][k], MODES_TOL) for k in ("a_seq", "pol_mean")]
        if max(errs_) > 0 or any(r["modes"][mode]["launches"]["block_gram_and_grad"]
                                 for r in ranks):
            raise AssertionError(f"sharded_modes {mode}: {errs_} beyond {MODES_TOL}")
        row[mode] = {"ms": res["ms"], "launches_per_rank": [r["modes"][mode]["launches"]
                                                            for r in ranks],
                     "excess_over_tol": errs_}
    emit(row)

    err = close(ranks[0]["planning"]["x"], x_single.cpu(), SVGD_TOL)
    for r in ranks:
        if (r["planning"]["launches"]["mxu_chain_fwd"], r["planning"]["launches"][
                "mxu_chain_bwd"]) != (PLAN_SHARD_STEPS, PLAN_SHARD_STEPS):
            raise AssertionError(f"sharded_planning: launches {r['planning']['launches']}")
    if err > 0:
        raise AssertionError(f"sharded_planning: {err} beyond {SVGD_TOL}")
    emit({"phase": "sharded_planning", "card": card(), "shape": [1024, 3, 7],
          "depth": cfg.depth, "steps": PLAN_SHARD_STEPS, "ranks": SHARD_RANKS,
          "excess_over_tol": err, "unsharded_ms_per_iter": plan_single_ms,
          "ms_per_iter": [r["planning"]["ms_per_iter"] for r in ranks],
          "launches_per_rank": [r["planning"]["launches"] for r in ranks]})

    errs_ = [close(ranks[0]["mpf"]["particles"], mpf_single.particles.cpu(), MPF_TOL),
             close(ranks[0]["mpf"]["grads"], grads_single.cpu(), (1e-4, 1e-6))]
    if max(errs_) > 0:
        raise AssertionError(f"sharded_mpf: {errs_}")
    emit({"phase": "sharded_mpf", "card": card(), "particles": cfg_m.mpf_n_particles,
          "steps": cfg_m.mpf_steps, "ranks": SHARD_RANKS, "excess_over_tol": errs_})

    stats = ranks[0]["collectives"]
    ag = stats.get("all-gather", {"count": 0, "bytes": 0})
    ar = stats.get("all-reduce", {"count": 0, "bytes": 0})
    if not (1 <= ag["count"] <= 5 and ar["count"] <= 2 * 45 + 10
            and (ag["bytes"] + ar["bytes"]) / 1e6 < 2.0):
        raise AssertionError(f"collectives: {stats} beyond the budget")
    emit({"phase": "collectives", "card": card(), "solve": "pendulum policy mode, 16 "
          "policies, 2 Adam steps", "ranks": SHARD_RANKS, "stats": stats,
          "nccl_1_rank": one.get("collectives"), "transport": ranks[0]["transport"]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy; one multi-threaded CPU exp)

    if sys.argv[1:] == ["--k9-timing"]:
        k9_timing()
        return 0
    if sys.argv[1:] == ["--maze"]:
        maze_phases()
        return 0
    if sys.argv[1:] == ["--planning"]:
        planning_phases()
        return 0
    if sys.argv[1:] == ["--lbfgs-mesh"]:
        lbfgs_mesh_phases()
        return 0
    if sys.argv[1:] == ["--parallel"]:
        parallel_phases()
        return 0
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank()
        return 0
    t_start = time.perf_counter()
    phase_build()
    k9_times = phase_k9_timing()
    maze_rows = phase_maze()
    plan_rows = phase_planning()
    lbfgs_rows = phase_lbfgs_mesh()
    par_rows = phase_parallel()
    k1 = phase_k1()
    k1_launches, kern0, taus = phase_flagship()
    k1_mc_launches = phase_mc_solve()
    phase_mc_small_vs_cpu()
    k3 = phase_k3()
    k7 = phase_k7()
    streamed0 = phase_lambda0_streamed_gram(kern0, *taus)
    sym = phase_gram_sym(kern0, taus[0])
    gg = phase_gram_and_grad_routes()
    k2 = phase_k2()
    pinned = phase_pinned()
    k9_launches = phase_policy()
    phase_trajectory()
    phase_scaled("ScaledSVGD")
    phase_scaled("MatrixSVGD")
    phase_default_sig()
    k8 = phase_k8()
    k8_launches = phase_planning_iter()
    k8_launches = (k8_launches["mxu_chain_fwd"], k8_launches["mxu_chain_bwd"])
    plan3 = phase_planning_iter(3)["block3_gram_and_grad"]
    plan0 = phase_planning_iter(0)["block_gram_and_grad"]
    phase_planning_run()
    k4 = phase_k4()
    k6 = phase_k6(k4)
    k4.pop("tiles")
    streamed = phase_streamed_gram()
    linear_solve, linear_tau = phase_pinned_linear()
    k5 = phase_k5(linear_tau)
    del linear_tau
    dense3 = phase_dense_lambda3_gram()
    c12 = phase_c12_pair_list()
    linear_streamed = phase_linear_streamed_gram(*taus)
    del taus
    k5_launches = {
        which: {"pinned_linear_solve": linear_solve["launches"][which],
                **{f"dense_lambda3_gram {st}": r["launches"][which] for st, r in dense3.items()},
                "c12_pair_list": c12["launches"][which],
                "linear_streamed_gram": linear_streamed["launches"][which]}
        for which in ("tiled_forward", "tiled_backward")}
    phase_small_vs_cpu()
    small_grams_vs_cpu()
    phase_trajectory_small_vs_cpu()
    phase_wavefront_small_vs_cpu()
    planning_small_vs_cpu()
    k9 = phase_k9(k9_times)
    maze_ep, k2m = maze_rows["maze_episode"][0], maze_rows["k2_maze_shape 35"][0]
    emit({"phase": "smoke_total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {**kernel_entry("sigkernel_block_gram_grad (K1)",
                        "sigsvgd_tpu_torch/csrc/sigkernel_block.cu",
                        "sigsvgd_tpu/kernels/pallas_sigkernel_block.py:199",
                        k1_launches, k1),
         "launches_by_path": {"flagship_solve": k1_launches, "mc_solve": k1_mc_launches,
                              "lambda0_gram_and_grad planning_knots_c7":
                                  gg[0]["planning_knots_c7"]["launches"]["block_gram_and_grad"],
                              "planning_iter_depth0": plan0,
                              **shard_launches(par_rows["sharded_flagship_solve"])},
         "by_shape": k1["by_shape"],
         "planning_knots_route_ms": {k: gg[0]["planning_knots_c7"][k]
                                     for k in ("block_route_ms", "pair_route_ms")}},
        {**kernel_entry("sigkernel_block3_gram_grad (K2)",
                        "sigsvgd_tpu_torch/csrc/sigkernel_block3.cu",
                        "sigsvgd_tpu/kernels/pallas_sigkernel_block3.py:113",
                        pinned[("pinned_solve", "block3_gram_and_grad")], k2),
         "launches_by_path": {"pinned_solve": pinned[("pinned_solve", "block3_gram_and_grad")],
                              "maze_episode": maze_ep["launches"]["block3_gram_and_grad"],
                              "maze_resume": lbfgs_rows["maze_resume"]["k2_launches"],
                              "obstacle_field":
                                  plan_rows["obstacle_field"]["launches"]["block3_gram_and_grad"],
                              "robot_planning_quick": plan_rows["robot_planning_quick"]
                                  ["launches"]["block3_gram_and_grad"],
                              "lambda3_gram_and_grad planning_knots_c7":
                                  gg[3]["planning_knots_c7"]["launches"]["block3_gram_and_grad"],
                              "planning_iter_depth3": plan3,
                              **shard_launches(par_rows["sharded_pinned_solve"])},
         "by_shape": k2["by_shape"],
         "planning_knots_route_ms": {k: gg[3]["planning_knots_c7"][k]
                                     for k in ("block_route_ms", "pair_route_ms")},
         "maze_shape": {k: k2m[k] for k in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                                            "bound_by", "k_max_abs_err")}
         | {"launches_per_maze_step": maze_ep["k2_launches_per_step"]},
         "field_shape": path_shape(plan_rows["k2_field_shape"], "fwd")},
        {**kernel_entry("svgd_velocity (K9)",
                        "sigsvgd_tpu_torch/csrc/svgd_velocity.cu",
                        "sigsvgd_tpu/kernels/pallas_svgd.py:37",
                        k9_launches, k9),
         **{k: k9[k] for k in ("kernel_graph_ms", "library_graph_ms", "fp32_bound_ms",
                               "by_shape")}},
        {**k8_entry("mxu_chain_fwd (K8 forward)", "sigsvgd_tpu/kernels/pallas_mxu_chain.py:107",
                    k8_launches[0], k8, "fwd"),
         "launches_by_path": {"planning_iter": k8_launches[0], "robot_planning_full":
                              plan_rows["robot_planning_full"]["launches"]["mxu_chain_fwd"],
                              **lbfgs_k8(lbfgs_rows, "mxu_chain_fwd"),
                              **parallel_k8(par_rows, "mxu_chain_fwd")},
         "sweep_shape": path_shape(plan_rows["k8_sweep_shape"], "fwd")},
        {**k8_entry("mxu_chain_bwd (K8 backward)", "sigsvgd_tpu/kernels/pallas_mxu_chain.py:132",
                    k8_launches[1], k8, "bwd"),
         "launches_by_path": {"planning_iter": k8_launches[1], "robot_planning_full":
                              plan_rows["robot_planning_full"]["launches"]["mxu_chain_bwd"],
                              **lbfgs_k8(lbfgs_rows, "mxu_chain_bwd"),
                              **parallel_k8(par_rows, "mxu_chain_bwd")},
         "sweep_shape": path_shape(plan_rows["k8_sweep_shape"], "bwd")},
        {**fused_entry("fused_forward (K4 forward)",
                       "sigsvgd_tpu/kernels/pallas_sigkernel.py:242",
                       pinned[("bf16_pinned_solve", "fused_forward")], k4, "fwd",
                       {"bf16_pinned_solve": pinned[("bf16_pinned_solve", "fused_forward")],
                        "streamed_gram": streamed["launches"]["fused_forward"],
                        "lambda3_gram_and_grad lc132":
                            gg[3]["lc132"]["launches"]["fused_forward"]}),
         "sweep_shape": path_shape(plan_rows["k4_sweep_shape"], "fwd")},
        {**fused_entry("fused_backward (K4 backward)",
                       "sigsvgd_tpu/kernels/pallas_sigkernel.py:735",
                       streamed["launches"]["fused_backward"], k4, "bwd",
                       {"streamed_gram": streamed["launches"]["fused_backward"],
                        "bf16_pinned_solve": pinned[("bf16_pinned_solve", "fused_backward")],
                        "lambda3_gram_and_grad lc132":
                            gg[3]["lc132"]["launches"]["fused_backward"]}),
         "sweep_shape": path_shape(plan_rows["k4_sweep_shape"], "bwd")},
        {**kernel_entry("sigkernel_block_gram (K3)",
                        "sigsvgd_tpu_torch/csrc/sigkernel_block.cu",
                        "sigsvgd_tpu/kernels/pallas_sigkernel_block.py:291",
                        sym["launches"]["block_gram"], k3),
         "launches_by_path": {"gram_sym [1024, 40, 2]": sym["launches"]["block_gram"],
                              "gram_sym [1024, 16, 8]": sym["c8"]["launches"]["block_gram"]},
         **{k: k3.get(k) for k in ("registers", "band_rows", "tiles", "sass_per_pair",
                                   "issue_floor_ms")}},
        small_entry("small_forward (K7 forward)",
                    "sigsvgd_tpu/kernels/pallas_sigkernel_small.py:88", streamed0, k7, gg[0],
                    "small_forward", par_rows["sharded_modes"]),
        small_entry("small_backward (K7 backward)",
                    "sigsvgd_tpu/kernels/pallas_sigkernel_small.py:174", streamed0, k7, gg[0],
                    "small_backward", par_rows["sharded_modes"]),
        {"name": "fused_backward_bf16 (K6)", "route": "cuda",
         "source": "sigsvgd_tpu_torch/csrc/sigkernel_fused.cu",
         "replaces": "sigsvgd_tpu/kernels/pallas_sigkernel.py:823", "shape": k6["shape"],
         "launches": pinned[("bf16_pinned_solve", "fused_backward_bf16")],
         "launches_by_path": {"bf16_pinned_solve":
                              pinned[("bf16_pinned_solve", "fused_backward_bf16")]},
         "max_abs_err": k6["max_abs_err"],
         "ms": k6["k6_ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": None},
        tiled_entry("tiled_forward (K5 forward)", "sigsvgd_tpu/kernels/pallas_sigkernel.py:185",
                    k5, k5_launches["tiled_forward"], "fwd"),
        tiled_entry("tiled_backward (K5 backward)", "sigsvgd_tpu/kernels/pallas_sigkernel.py:293",
                    k5, k5_launches["tiled_backward"], "bwd"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
