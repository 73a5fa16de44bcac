"""Where K7's forward and backward spend their time: copies of their source
with one part cut.

    python3 tools/k7_probe.py [--also NAME=FILE ...] [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/sigkernel_small.cu`` as it is and copies of
it, each with one part cut by a textual edit (so the cut kernel's output is
wrong on purpose and only its times count): ``fwd_no_fac_store`` (the
residual forward's lanes still fill the stage, the block never writes it
out), ``fwd_statics_only`` (the static rows, z, A and B of every row, no
sweep and no residual), ``bwd_no_pull_back`` (no dz is pulled back through
the statics) and ``bwd_no_stage_in`` (no residual row is copied into the
stage: the adjoint reads a stale one). A cut disables its part with a
condition that is false only at run time, so the kernel compiles as it is
and the cut part's inputs stay live. ``--also`` adds other sources of the
same C interface to time beside them. Each runs at a list of 2^20 pairs
(every pair of two of ``chip_smoke.py``'s seeded smooth [1024, 40, 2]
batches at h = 4, the streamed λ=0 Gram's shape), timed by CUDA events, 3
calls a sample, in the order kernel, cuts, cuts reversed, kernel. The
kernel as it is, and each ``--also`` source, is held against the twin on
the first and last 4,096 pairs (k and fac atol 3e-5, dx and dy scaled
5e-5) and bit for bit across two calls. The ptxas figures (registers, spill
bytes, stack frame) of every function of every copy are reported, and
where ``cuobjdump`` is found the instructions of the flagship's
instantiations (span 5, C = 2) of the three kernels in the kernel's SASS
are counted by kind. The cuts are exact lines of the source: after an edit
of those lines the probe stops with the cut's name, and its ``CUTS`` must
follow the source. One JSON line a measurement (also to ``FILE``, default
``build/k7_probe.jsonl``). Needs a CUDA card; imports nothing of JAX.
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
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "sigkernel_small.cu"
BUILD = ROOT / "build" / "k7_probe"

_PULL = ("          pull_back<C>(__fsub_rn(dz, dzr), gs[q + 1], gl_r, y[q + 1], dy[q + 1], xh, "
         "xl, sxh,",
         "          if (lx1 < 0) pull_back<C>(__fsub_rn(dz, dzr), gs[q + 1], gl_r, y[q + 1], "
         "dy[q + 1], xh, xl, sxh,")
_PULL0 = ("          pull_back<C>(-dzr, gs[0], gl_r, y[0], dy[0], xh, xl, sxh, sxl, swh, swl);",
          "          if (lx1 < 0) pull_back<C>(-dzr, gs[0], gl_r, y[0], dy[0], xh, xl, sxh, sxl, "
          "swh, swl);")
CUTS = {
    "fwd_no_fac_store": [
        ("        if (cu.m >= 0 && cu.r < runs) {\n          const size_t p0 = cu.p - gi;",
         "        if (cu.m >= 0 && cu.r < runs && lx1 < 0) {\n          const size_t p0 = cu.p - gi;")],
    "fwd_statics_only": [
        ("          const Coef cf = coef(gu1, gu0, gl1, gl0);\n",
         "          const Coef cf = coef(gu1, gu0, gl1, gl0);\n"
         "          if (lx1 > 0) {\n"
         "            kl += cf.A - cf.B;\n"
         "            grow[q] = gu0;\n"
         "            gu0 = gu1;\n"
         "            gl0 = gl1;\n"
         "            continue;\n"
         "          }\n")],
    "bwd_no_pull_back": [_PULL, _PULL0],
    "bwd_no_stage_in": [
        ("      if (au.m >= 0 && au.r < runs) {", "      if (au.m >= 0 && au.r < runs && lx1 < 0) {")],
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
    """Instructions of the flagship's instantiations (span 5, C = 2) of K7's
    forward (values only, with the residual) and backward in ``lib``'s
    SASS, by opcode (the 12 most frequent) and in all."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    names = {"small_fwd_lanes_kernelILi5ELi2ELb0E": "fwd_values",
             "small_fwd_lanes_kernelILi5ELi2ELb1E": "fwd_residual",
             "small_bwd_lanes_kernelILi5ELi2E": "bwd"}
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        which = next((v for k, v in names.items() if k in name), None)
        if which:
            ops = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part))
            out[which] = {"all": sum(ops.values()), **dict(ops.most_common(12))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=FILE: another source of the same C interface to time")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k7_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    base = SRC.read_text()
    sources = {"kernel": base}
    also = dict(a.split("=", 1) for a in args.also)
    for name, path in also.items():
        sources[name] = Path(path).read_text()
    for name, edits in CUTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"k7_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)
    import chip_smoke as cs
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    from sigsvgd_tpu_torch.kernels import sigkernel_small as ks

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"card": smi, "sass": sass_counts(libs["kernel"][1]),
          "ptxas": {name: cs.ptxas_functions(report) for name, (_, _, report) in libs.items()}})
    tree = ks._lib()
    fns = ("sigkernel_small_resident", "sigkernel_small_fwd", "sigkernel_small_bwd")
    for lib, _, _ in libs.values():
        for fn in fns:
            getattr(lib, fn).argtypes = getattr(tree, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(8)
    X, Y = cs.smooth_paths(1024, 40, 2, gen), cs.smooth_paths(1024, 40, 2, gen)
    idx = torch.arange(1 << 20, device="cuda")
    xt, yt = cs.pair_tiles(X, Y, idx // 1024, idx % 1024, 4.0)
    g = torch.randn(1 << 20, generator=gen, device="cuda")
    del idx
    P = xt.shape[2]
    held = torch.cat([torch.arange(4096, device="cuda"), torch.arange(P - 4096, P, device="cuda")])
    kp, facp, dxp, dyp = cs.small_twin(xt[..., held], yt[..., held], g[held], torch.float32)
    _, fac = ks.small_forward(xt, yt, residuals=True)

    def use(lib):
        ks._lib = lambda: lib
        ks.resident_blocks.cache_clear()

    times = {name: collections.defaultdict(list) for name in libs}
    order = list(libs) + list(libs)[::-1]
    checked = set()
    for name in order:
        use(libs[name][0])
        ks.small_forward(xt, yt, residuals=True)
        ks.small_forward(xt, yt, residuals=False)
        ks.small_backward(xt, yt, fac, g)
        torch.cuda.synchronize()
        if (name == "kernel" or name in also) and name not in checked:
            checked.add(name)
            (kv,) = ks.small_forward(xt, yt, residuals=False)
            k, fac2 = ks.small_forward(xt, yt, residuals=True)
            dx, dy = ks.small_backward(xt, yt, fac2, g)
            again = ks.small_backward(xt, yt, fac2, g)
            emit({"check": f"{name} against the twin", "pairs_held": held.numel(),
                  "k_max_abs_err": (k[held] - kp).abs().max().item(),
                  "fac_max_abs_err": (fac2[..., held] - facp).abs().max().item(),
                  "dx_scaled_err": cs.scaled_err(dx[..., held], dxp),
                  "dy_scaled_err": cs.scaled_err(dy[..., held], dyp),
                  "values_only_equal": bool(torch.equal(kv, k)),
                  "bwd_bit_equal_across_calls": bool(torch.equal(dx, again[0])
                                                     and torch.equal(dy, again[1]))})
            del kv, k, fac2, dx, dy, again
        for _ in range(2):
            times[name]["fwd_values_ms"].append(
                cs.event_ms(lambda: ks.small_forward(xt, yt, residuals=False), 3))
            times[name]["fwd_ms"].append(
                cs.event_ms(lambda: ks.small_forward(xt, yt, residuals=True), 3))
            times[name]["bwd_ms"].append(
                cs.event_ms(lambda: ks.small_backward(xt, yt, fac, g), 3))
    use(tree)
    for name in libs:
        emit({"variant": name, "pairs": P, "shape": [[1024, 40, 2], [1024, 40, 2]],
              **{k: statistics.median(v) for k, v in times[name].items()},
              "samples": times[name]})
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
