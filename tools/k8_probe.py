"""Where K8 spends its time: copies of its source with one part cut.

    python3 tools/k8_probe.py [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/mxu_chain.cu`` as it is and copies of it,
each with one part cut by a textual edit (so their outputs are wrong on
purpose and only their times count): ``ring_only`` (the consumers wait for
each staged slice and release it, and do nothing else with it: the basis
ring and the hop skeleton alone), ``forward_only`` (the backward's reverse
pass does the same: the forward recompute alone), ``no_d_in`` (the reverse
pass without the d_in product) and ``no_u_rebuild`` (the reverse pass
without rebuilding U_d and its dz term). A cut skips its part with a
condition that is false only at run time, so the kernel compiles as it is
and the ring still sees every slice. Each runs at the planning shape
[1048576, 2, 2] λ=6 on ``chip_smoke.py``'s seeded knot increments, timed by
CUDA events (forward 5 calls a sample, backward 3) in the order kernel,
cuts, cuts reversed, kernel; the kernel as it is is held against the twin
on the first 131,072 pairs. The ptxas figures (registers, spills, stack
frame) of both instantiations of every copy, and the wgmma fences ptxas
injected (C7519), are reported. The cuts are exact lines of the source:
after an edit of those lines the probe stops with the cut's name, and its
``CUTS`` must follow the source. One JSON line a measurement (also to
``FILE``, default ``build/k8_probe.jsonl``). Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "mxu_chain.cu"
BUILD = ROOT / "build" / "k8_probe"

_FWD_WAIT = "    const uint32_t slice = ring.wait();\n    float u1[36], u2[36];\n"
_REV_WAIT = "      const uint32_t slice = ring.wait();\n      float zd[2] = {zp[0], zp[1]};  // z^d\n"


def _skip(wait: str, cond: str) -> tuple:
    """Release the stage right after waiting for it, and skip the rest."""
    pad = wait[: len(wait) - len(wait.lstrip())]
    first = wait.splitlines(keepends=True)[0]
    return wait, first + f"{pad}if ({cond}) {{\n{pad}  ring.release();\n{pad}  continue;\n{pad}}}\n" \
        + wait[len(first):]


CUTS = {
    "ring_only": [_skip(_FWD_WAIT, "th.p->B > 0"), _skip(_REV_WAIT, "p.B > 0")],
    "forward_only": [_skip(_REV_WAIT, "p.B > 0")],
    "no_d_in": [("        wgmma_n128_mnmajor(din, wa, desc_mnmajor(slice, ks));\n",
                 "        if (p.B < 0) wgmma_n128_mnmajor(din, wa, desc_mnmajor(slice, ks));\n")],
    "no_u_rebuild": [("      if (d > 0) {\n        float part[2] = {0.f, 0.f};\n",
                      "      if (d > 0 && p.B < 0) {\n        float part[2] = {0.f, 0.f};\n")],
}


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
        libs[name] = (ctypes.CDLL(str(lib)), report)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k8_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    base = SRC.read_text()
    sources = {"kernel": base}
    for name, edits in CUTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"k8_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    import chip_smoke as cs
    from sigsvgd_tpu_torch.kernels import mxu_chain as mc

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"card": smi,
          "ptxas": {name: {f: r for f, r in cs.ptxas_functions(rep).items()
                           if "chain_kernel" in f}
                    for name, (_, rep) in libs.items()},
          "injected_wgmma_fences": {name: rep.count("C7519") for name, (_, rep) in libs.items()}})
    for lib, _ in libs.values():
        mc.bind(lib)

    gen = torch.Generator(device="cuda").manual_seed(8)
    inc = cs.knot_increments(1024, gen)
    B = inc.shape[0]
    g = torch.randn(B, generator=gen, device="cuda")
    z = (inc / float(4 ** 6)).reshape(B, 4).contiguous()
    del inc
    geom = (2, 2, 1, 2)
    n = 131072
    kp = mc._plain_forward(z[:n], *geom, 10)[0]
    dp = mc._plain_backward(z[:n], g[:n], *geom, 10)
    lib0 = libs["kernel"][0]
    k = mc.launch(z, None, *geom, 10, False, lib0)
    dz = mc.launch(z, g, *geom, 10, True, lib0)
    torch.cuda.synchronize()
    emit({"check": "kernel against the twin", "pairs": n,
          "k_scaled_err": ((k[:n] - kp).abs().max() / kp.abs().max()).item(),
          "dz_scaled_err": ((dz[:n] - dp).abs().max() / dp.abs().max()).item()})
    del k, dz, kp, dp

    times = {name: {"forward": [], "backward": []} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        mc.launch(z, None, *geom, 10, False, lib)
        mc.launch(z, g, *geom, 10, True, lib)
        times[name]["forward"].append(
            cs.event_ms(lambda: mc.launch(z, None, *geom, 10, False, lib), 5))
        times[name]["backward"].append(
            cs.event_ms(lambda: mc.launch(z, g, *geom, 10, True, lib), 3))
    for name in libs:
        emit({"variant": name, "shape": [B, 2, 2], "dyadic_order": 6,
              **{f"{w}_ms": statistics.median(t) for w, t in times[name].items()},
              **{f"{w}_samples": t for w, t in times[name].items()}})
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
