"""Where K1 spends its time: copies of its source with one part cut.

    python3 tools/k1_probe.py [--also NAME=FILE ...] [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/sigkernel_block.cu`` as it is and copies of
it, each with one part of K1 cut by a textual edit (so their dX is wrong on
purpose and only their times count): ``no_adjoint`` (no unit of the adjoint
pipeline is active: the forward alone, with the adjoint's empty steps),
``no_remat`` (the adjoint rebuilds no band: its rows read stale factors),
``no_adjoint_rows`` (the band is rebuilt, its λ rows never run),
``no_pull_back`` (the λ rows run, their dz is pulled back nowhere: the
compiler drops the node weights), ``no_adjoint_statics`` (the λ rows take
the row above's statics in place of their own exps) and ``no_slot_loads``
(the adjoint copies no slot: each band is rebuilt from a stale buffer). A
cut disables its part with a condition that is false only at run time, or
drops a statement, so the kernel compiles as it is. ``--also`` adds other
sources of the same C interface (an earlier K1, say) to time beside them.
Each runs at the flagship shape [1024, 40, 2] on ``chip_smoke.py``'s
seeded smooth paths, timed by CUDA events, 3 calls a sample, in the order
kernel, cuts, cuts reversed, kernel. The kernel as it is, and each
``--also`` source, is held against the twin (K bit for bit, dX scaled).
Where ``cuobjdump`` is found, the instructions of K1's [1024, 40, 2]
instantiation in the kernel's SASS are counted by kind. The cuts are exact
lines of the source: after an edit of those lines the probe stops with the
cut's name, and its ``CUTS`` must follow the source. One JSON line a
measurement (also to ``FILE``, default ``build/k1_probe.jsonl``). Needs a
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "sigkernel_block.cu"
BUILD = ROOT / "build" / "k1_probe"

CUTS = {
    "no_adjoint": [("        const bool act = mine && a < n && b < n && a <= b;",
                    "        const bool act = mine && a < n && b < n && a <= b && L < 0;")],
    "no_remat": [("""#pragma unroll
          for (int s = 0; s < RB; ++s) {
            const bool on_r = i0 + s < L1;
            stat_row<SPAN, C>(xr + min(i0 + s + 1, L1) * xrow, yl, gu);""", """          if (L < 0) {
#pragma unroll
          for (int s = 0; s < RB; ++s) {
            const bool on_r = i0 + s < L1;
            stat_row<SPAN, C>(xr + min(i0 + s + 1, L1) * xrow, yl, gu);"""),
                 ("          // gu holds the static row at the band's top",
                  "          }\n          // gu holds the static row at the band's top")],
    "no_adjoint_rows": [("          if (act) {\n            // a row past L-2",
                         "          if (act && L < 0) {\n            // a row past L-2")],
    "no_pull_back": [("            pull_row<SPAN, C>(W, xr + min(i0 + s + 1, L1) * xrow, yl, cx, cw, hi);\n",
                      "")],
    "no_adjoint_statics": [("            stat_row<SPAN, C>(xr + min(i0 + s, L1) * xrow, yl, gd);\n",
                            "            for (int q = 0; q <= SPAN; ++q) gd[q] = gu[q] * 0.75f;\n")],
    "no_slot_loads": [("        if (vq < 0 || vq >= U) return;",
                       "        if (vq < 0 || vq >= U || L > 0) return;")],
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
        libs[name] = (ctypes.CDLL(str(lib)), lib, report)
    return libs


def sass_counts(lib: Path) -> dict:
    """Instructions of K1's span-5, C = 2 instantiation in ``lib``'s SASS,
    by kind."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if re.search(r"block_lanes_kernelILi5ELi2E", name):
            ops = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part))
            return {"all": sum(ops.values()), **dict(ops.most_common(24))}
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=FILE: another source of the same interface")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device; nothing was run", file=sys.stderr)
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
                raise SystemExit(f"k1_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    also = dict(a.split("=", 1) for a in args.also)
    for name, path in also.items():
        sources[name] = Path(path).read_text()
    libs = build(sources)
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    import chip_smoke as cs
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"card": smi, "sass": sass_counts(libs["kernel"][1]),
          "ptxas": {name: {f: r for f, r in cs.ptxas_functions(rep).items()
                           if "ILi5ELi2E" in f and "lanes" in f}
                    for name, (_, _, rep) in libs.items()}})
    tree = kb._lib()
    for name, (lib, _, _) in libs.items():
        for fn in ("sigkernel_block_grid", "sigkernel_block_gram_grad", "sigkernel_block_gram"):
            getattr(lib, fn).argtypes = getattr(tree, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int

    h = 4.0
    X = cs.smooth_paths(1024, 40, 2, torch.Generator(device="cuda").manual_seed(0))
    Kp, dXp = kb.block_gram_and_grad_plain(X, h)
    times = {name: [] for name in libs}
    order = list(libs) + list(libs)[::-1]
    checked = set()
    for name in order:
        kb._lib = lambda lib=libs[name][0]: lib
        K, dX = kb.block_gram_and_grad(X, h)
        torch.cuda.synchronize()
        if (name == "kernel" or name in also) and name not in checked:
            checked.add(name)
            emit({"check": f"{name} against the twin",
                  "k_bit_equal": bool(torch.equal(K, Kp)),
                  "dx_scaled_err": ((dX - dXp).abs().max() / dXp.abs().max()).item()})
        for _ in range(2):
            times[name].append(cs.event_ms(lambda: kb.block_gram_and_grad(X, h), 3))
        del K, dX
    kb._lib = lambda: tree
    for name in libs:
        emit({"variant": name, "shape": [1024, 40, 2],
              "ms": statistics.median(times[name]), "samples": times[name]})
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
