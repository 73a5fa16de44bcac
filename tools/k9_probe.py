"""Where K9's time goes on one card: copies of its source with one part cut.

    python3 tools/k9_probe.py [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/svgd_velocity.cu`` as it is and four
copies, each with one part cut out by a textual edit (so their results are
wrong on purpose and only their times count): ``one_pass`` (one TF32 product
instead of 3xTF32's three), ``no_split`` (the operands' raw fp32 bits as
hi and as lo: three products, no split), ``no_loads`` (no copy after the
first k-slice: the math on stale tiles) and ``no_math`` (the copies and
the epilogues, no products). Each runs at N = 1024 and D = 256 (128 of
kernel B's tiles: one a streaming multiprocessor), 280, 840 and 1400, and
the device time of each of its two kernels is read from a
``torch.profiler`` trace of 20 calls, as the mean over the launches the
trace recorded (a session can miss some). The cuts are exact lines of the
source: after an edit of those lines the probe stops with the cut's name,
and its ``CUTS`` must follow the source. A last kernel measures what ``mma.sync`` m16n8k8 TF32 gives on
its own: 16 independent accumulators a warp, at 4, 8 and 16 warps an SM.
One JSON line a measurement (also to ``FILE``, default
``build/k9_probe.jsonl``). Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "svgd_velocity.cu"
BUILD = ROOT / "build" / "k9_probe"

CUTS = {
    "one_pass": [("""  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);""", "  mma_tf32(c, ah, bh[0], bh[1]);")],
    "no_split": [("""  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));""", "  hi = lo = __float_as_uint(a);")],
    "no_loads": [("    if (slice + 1 < nk) load(slice + 1, (slice + 1) & 1);", ""),
                 ("    if (slice + 1 < nj) load(slice + 1, (slice + 1) & 1);", "")],
    "no_math": [("    warp_slice<true, false>(a, b, wm, kw, g, q, part, nullptr);", ""),
                ("    warp_slice<false, true>(Ks[slice & 1], Vs[slice & 1], wm, kw, g, q, part, rs);",
                 "")],
}

HMMA = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void hmma_loop(float* out, int iters) {
  float c[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int n = 0; n < 16; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int hmma_bench(float* out, int iters, int blocks, int threads, void* stream) {
  hmma_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build(sources: dict) -> dict:
    """Each source to its own library, all nvcc processes started together."""
    from sigsvgd_tpu_torch.kernels import _build

    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = BUILD / f"{name}.cu", BUILD / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def kernel_ms(fn, calls: int = 20) -> dict:
    """Device ms a launch of each of K9's two kernels (one launch a call
    each), after a warm-up, and the launches the trace recorded."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("gram", "apply"):
            if e.device_type == torch.autograd.DeviceType.CUDA and f"{name}_kernel" in e.key:
                out[name] = e.self_device_time_total / 1e3 / e.count
                out[f"{name}_recorded"] = e.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k9_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    base = SRC.read_text()
    sources = {"kernel": base, "hmma": HMMA}
    for name, edits in CUTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k9_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    from sigsvgd_tpu_torch.kernels import svgd_velocity as kv
    from sigsvgd_tpu_torch.utils.math import bw_median, pw_dist_sq

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"card": smi})
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(5)
    for D in (256, 280, 840, 1400):
        N = 1024
        x = torch.rand((N, D), generator=gen, device="cuda") * 4.0 - 2.0
        s = torch.randn((N, D), generator=gen, device="cuda")
        h = bw_median(pw_dist_sq(x, x)).reshape(1)
        ld = -(-D // 4) * 4
        xc = torch.nn.functional.pad(x - x.mean(0, keepdim=True), (0, ld - D)).contiguous()
        sc = torch.nn.functional.pad(s, (0, ld - D)).contiguous()
        plan = kv.velocity_plan(N, D)
        kbuf = torch.empty(plan.scratch_bytes // 4, device="cuda")
        phi = torch.empty((N, D), device="cuda")
        for name in ("kernel", *CUTS):
            fn = libs[name].svgd_velocity
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn):
                rc = fn(xc.data_ptr(), sc.data_ptr(), h.data_ptr(), phi.data_ptr(),
                        kbuf.data_ptr(), N, D, ld, plan.rows, plan.cols, stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            emit({"shape": [N, D], "variant": name, "apply_blocks": plan.blocks_apply,
                  **kernel_ms(call)})
    bench = libs["hmma"].hmma_bench
    bench.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 512, device="cuda")
    iters = 4000
    for warps in (4, 8, 16):
        bench(buf.data_ptr(), iters, sms, 32 * warps, stream)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        bench(buf.data_ptr(), iters, sms, 32 * warps, stream)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1)
        mmas = sms * warps * iters * 16
        emit({"mma_sync_tf32_warps_a_sm": warps, "ms": ms,
              "tflops": mmas * 2 * 16 * 8 * 8 / ms / 1e9})
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
