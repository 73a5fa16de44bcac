"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from ``sigsvgd_tpu_torch/csrc`` with nvcc for sm_90a;
2. K1 (the λ=0 signature-kernel Gram + adjoint) against its plain PyTorch
   twin on the card, at the flagship shape [1024, 40, 2], a ragged
   [333, 40, 2] and [40, 64, 3] (the L ≤ 64 instantiation): K to atol
   3e-5, dX scaled by max|dX| to atol 5e-5; also K of both against the twin
   in fp64, and the device memory each instantiation's first launch takes;
3. the flagship DuSt solve (7-DoF Panda, bookshelf_small, 1024 policies,
   H=40, 2 Adam SVGD steps, calibrated order 0) for a few chained MPC
   solves, with K1's launch count read around them, then the two stages of
   the solve timed apart (rollout + cost gradient; Gram + adjoint) and one
   more solve traced with ``torch.profiler``;
4. a small solve on the card held against the same solve on the CPU, where
   the twin replaces K1.

Then the kernel table line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

N_SOLVES = 3
OPT_STEPS = 2
PEAK_FP32_FLOPS = 67e12  # H100 SXM, CUDA cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def emit(obj) -> None:
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


def host_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


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

    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {stem: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, text in reports.items()}
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "ptxas": ptxas})
    return smi


def device_mib_outside_allocator(fn) -> float:
    """Device memory that ``fn`` takes outside PyTorch's caching allocator
    (for a first kernel launch: the module and its local-memory reserve)."""
    torch.cuda.synchronize()
    free0, res0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    fn()
    torch.cuda.synchronize()
    free1, res1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    return ((free0 - free1) - (res1 - res0)) / 2**20


def phase_k1():
    """K1 against its plain twin at the flagship shape, a ragged n, and the
    L ≤ 64 instantiation; both also against the twin in fp64."""
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    gen = torch.Generator(device="cuda").manual_seed(0)
    h = 4.0
    rows = {}
    for n, L, C in ((1024, 40, 2), (333, 40, 2), (40, 64, 3)):
        X = smooth_paths(n, L, C, gen)
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
        finite = bool(torch.isfinite(K).all() and torch.isfinite(dX).all())
        row = {"phase": "k1_vs_plain", "shape": [n, L, C], "h": h,
               "k_max_abs_err": k_err, "dx_scaled_max_abs_err": dx_err,
               "k_err_vs_fp64": {"kernel": (K.double() - K64).abs().max().item(),
                                 "plain": (Kp.double() - K64).abs().max().item()},
               "first_launch_mib_outside_allocator": mib,
               "finite": finite}
        del K64, dX64
        if n == 1024:
            kernel_ms = event_ms(lambda: kb.block_gram_and_grad(X, h), 5)
            plain_ms = event_ms(lambda: kb.block_gram_and_grad_plain(X, h), 1)
            flops, nbytes = kb.block_flops(n, 40, 2), kb.block_bytes(n, 40, 2)
            row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                       flops=flops, bytes=nbytes,
                       bound_ms=max(flops / PEAK_FP32_FLOPS,
                                    nbytes / PEAK_BYTES) * 1e3,
                       bound_by=("operations" if flops / PEAK_FP32_FLOPS
                                 >= nbytes / PEAK_BYTES else "bytes"))
            rows["flagship"] = row
        emit(row)
        if not (finite and k_err <= 3e-5 and dx_err <= 5e-5):
            raise AssertionError(f"K1 disagrees with its plain twin: {row}")
    return rows["flagship"]


def phase_flagship():
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    t0 = time.perf_counter()
    prob = build_arm_mpc(device="cuda", n_pol=1024, hz_len=40)
    ctrl = prob.ctrl
    if ctrl.sig_kernel.dyadic_order != 0:
        raise AssertionError("calibration did not choose order 0")
    cs = ctrl.init(generator=torch.Generator(device="cuda").manual_seed(1))
    state = prob.q_start
    # warm-up solve (first-call allocations), not counted
    ctrl.forward(state, cs, opt_steps=OPT_STEPS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    kb.block_gram_and_grad.launches = 0
    finite = True
    solve_ms = []
    for _ in range(N_SOLVES):
        t1 = time.perf_counter()
        a_seq, cs, data = ctrl.forward(state, cs, opt_steps=OPT_STEPS)
        state = prob.model.step(state[None], a_seq[0:1])[0]
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t1) * 1e3)
        finite &= bool(torch.isfinite(a_seq).all()
                       and torch.isfinite(cs.pol_mean).all()
                       and torch.isfinite(data.costs).all())
    launches = kb.block_gram_and_grad.launches
    shapes = (tuple(a_seq.shape), tuple(cs.pol_mean.shape), tuple(data.costs.shape))
    if shapes != ((ctrl.hz_len, 7), (ctrl.n_pol, ctrl.hz_len, 7),
                  (OPT_STEPS, ctrl.n_pol)):
        raise AssertionError(f"unexpected output shapes {shapes}")
    if not finite:
        raise AssertionError("non-finite output from the flagship solve")
    if launches != OPT_STEPS * N_SOLVES:
        raise AssertionError(f"K1 launched {launches} times in {N_SOLVES} solves")

    # the two stages bench.py separates, timed apart (launches not counted)
    pol0 = cs.pol_mean

    def stage_rollout():
        pm = pol0.detach().requires_grad_(True)
        c, _tr = ctrl._rollout_costs(state, pm)
        torch.autograd.grad(c.sum(), pm)

    with torch.no_grad():
        _c, trs = ctrl._rollout_costs(state, pol0)
        tau = ctrl._tau(trs).contiguous()
    rollout_ms = host_ms(stage_rollout, 3)
    gram_ms = host_ms(lambda: ctrl.sig_kernel.gram_and_grad(tau), 3)
    trace = traced_solve(ctrl, state, cs)
    row = {"phase": "flagship_solve", "n_pol": ctrl.n_pol, "hz_len": ctrl.hz_len,
           "opt_steps": OPT_STEPS, "n_solves": N_SOLVES,
           "dyadic_order": ctrl.sig_kernel.dyadic_order,
           "calibration_bound": prob.calibration_bound,
           "ms_per_solve_median": statistics.median(solve_ms),
           "ms_per_solve_samples": solve_ms, "k1_launches": launches,
           "stages_ms": {"rollout_cost_grad": rollout_ms,
                         "sig_gram_adjoint": gram_ms},
           "traced_solve": trace,
           "setup_s": setup_s, "final_cost_min": data.costs[-1].min().item(),
           "finite": finite}
    emit(row)
    return launches


def traced_solve(ctrl, state, cs) -> dict:
    """One more solve under ``torch.profiler``: device busy time summed over
    kernels, the traced solve's wall time and idle share, kernel launches,
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctrl.forward(state, cs, opt_steps=OPT_STEPS)
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
    on the CPU (where the twin replaces K1): costs, K and the kernel
    gradient."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    out = {}
    for dev in ("cuda", "cpu"):
        prob = build_arm_mpc(device=dev, n_pol=16, hz_len=8)
        pol = (torch.rand((16, 8, 7), generator=torch.Generator().manual_seed(2))
               * 4.0 - 2.0).to(dev)
        cs = prob.ctrl.init(pol_mean=pol)
        prior = ParticleGMM(pol.reshape(16, -1), prob.ctrl._prior_var(),
                            cs.prior_weights)
        score, _tr = prob.ctrl._score(pol, prob.q_start, prior)
        out[dev] = [t.detach().cpu() for t in
                    (score.aux["costs"], score.k_xx, score.grad_k)]
    (c0, k0, g0), (c1, k1, g1) = out["cuda"], out["cpu"]
    errs = {"costs_rel": ((c0 - c1).abs().max() / c1.abs().max()).item(),
            "k_abs": (k0 - k1).abs().max().item(),
            "grad_k_scaled": ((g0 - g1).abs().max() / g1.abs().max()).item()}
    emit({"phase": "small_solve_cuda_vs_cpu", **errs})
    if not (errs["costs_rel"] <= 1e-5 and errs["k_abs"] <= 3e-5
            and errs["grad_k_scaled"] <= 5e-5):
        raise AssertionError(f"card and CPU solves disagree: {errs}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import sigsvgd_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)

    phase_build()
    k1 = phase_k1()
    launches = phase_flagship()
    phase_small_vs_cpu()
    emit({"kernels": [{
        "name": "sigkernel_block_gram_grad (K1)",
        "route": "cuda",
        "source": "sigsvgd_tpu_torch/csrc/sigkernel_block.cu",
        "replaces": "sigsvgd_tpu/kernels/pallas_sigkernel_block.py:199",
        "launches": launches,
        "max_abs_err": k1["k_max_abs_err"],
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
