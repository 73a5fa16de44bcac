"""Where K5's backward spends its time: copies of its source with one part cut.

    python3 tools/k5_probe.py [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/sigkernel_tiled.cu`` as it is and five
copies, each with one part of the backward cut by a textual edit (so their
dz is wrong on purpose and only their times count): ``no_rebuild_pipeline``
(the rebuild pipeline never runs: the adjoint reads stale ring slots),
``no_adjoint_pipeline``, ``no_second_rebuild`` (the adjoint pipeline's span
rebuild for the cells' left columns), ``no_dz_sums`` (dz written without its
two sums, which the compiler then drops) and ``no_checkpoint_rows`` (no
checkpoint row is copied: both pipelines start each segment from stale
rows). A cut disables its part with a condition that is false only at run
time, so the kernel compiles as it is. Each runs at the flagship linear
list, the upper triangle of 1024 smooth 40-point paths (cumulative steps of
at most 0.1, × 4) on linear statics, 524,800 pairs; the kernels are timed
by CUDA events, 3 calls a sample, in the order kernel, cuts, cuts reversed,
kernel. The kernel as it is is held against the twin on the first and last
4,096 pairs (k and the checkpoints bit for bit, dz scaled). Where
``cuobjdump`` is found, the instructions of each K5 function in the
kernel's SASS are counted by kind. The cuts are exact lines of the source:
after an edit of those lines the probe stops with the cut's name, and its
``CUTS`` must follow the source. One JSON line a measurement (also to
``FILE``, default ``build/k5_probe.jsonl``). Needs a CUDA card; imports
nothing of JAX.
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
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "sigkernel_tiled.cu"
BUILD = ROOT / "build" / "k5_probe"

CUTS = {
    "no_rebuild_pipeline": [("    if (u1 >= 0 && u1 < U) {",
                             "    if (u1 >= 0 && u1 < U && lx1 < 0) {")],
    "no_adjoint_pipeline": [("""    cp_async_commit();
    if (u2 >= 0 && u2 < U) {""", """    cp_async_commit();
    if (u2 >= 0 && u2 < U && lx1 < 0) {""")],
    "no_second_rebuild": [("            if (kk < nspan - 1) {",
                           "            if (kk < nspan - 1 && zc[kk] > 1e30f) {")],
    "no_dz_sums": [("""            dz[((size_t)b * ly1 + cc) * P + p] =
                __fmaf_rn(__fadd_rn(0.5f, zs), s1, __fmul_rn(zs, s2));""",
                    "            dz[((size_t)b * ly1 + cc) * P + p] = zs;")],
    "no_checkpoint_rows": [("  if (u < 0 || u >= U) return;",
                            "  if (u < 0 || u >= U || lx1 > 0) return;")],
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
    """Instructions of each K5 kernel in ``lib``'s SASS: floating point
    (FFMA, FMUL, FADD) and all, by kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part))
        which = re.search(r"tiled_(fwd|bwd)_kernelILi(\d)", name)
        if which:
            out[f"{which.group(1)}<{which.group(2)}>"] = {
                "all": sum(ops.values()), "FFMA": ops["FFMA"], "FMUL": ops["FMUL"],
                "FADD": ops["FADD"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k5_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_probe: no CUDA device; nothing was run", file=sys.stderr)
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
                raise SystemExit(f"k5_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"card": smi, "sass": sass_counts(libs["kernel"][1])})
    tree = kt._lib()
    for name, (lib, _, _) in libs.items():
        for fn in ("sigkernel_tiled_fwd", "sigkernel_tiled_bwd", "sigkernel_tiled_resident"):
            getattr(lib, fn).argtypes = getattr(tree, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = (torch.rand((1024, 40, 2), generator=gen, device="cuda") - 0.5) * 0.2
    X = torch.cumsum(steps, dim=1) * 4.0
    iu, ju = torch.triu_indices(1024, 1024, device="cuda")
    z = kt.pair_increments(X, X, iu, ju, None).contiguous()
    g = torch.where(iu == ju, 1.0, 2.0)
    del iu, ju
    P = z.shape[-1]

    def event_ms(fn, iters=3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    times = {name: collections.defaultdict(list) for name in libs}
    order = list(libs) + list(libs)[::-1]
    for i, name in enumerate(order):
        kt._lib = lambda lib=libs[name][0]: lib
        _, ck = kt.tiled_forward(z, True)
        dz = kt.tiled_backward(z, ck, g)
        torch.cuda.synchronize()
        if name == "kernel" and i == 0:
            held = torch.cat([torch.arange(4096, device="cuda"),
                              torch.arange(P - 4096, P, device="cuda")])
            k, _ = kt.tiled_forward(z, True)
            kp, ckp = kt.tiled_forward_plain(z[..., held], True)
            dzp = kt.tiled_backward_plain(z[..., held], ckp, g[held])
            emit({"check": "kernel against the twin", "pairs_held": held.numel(),
                  "k_bit_equal": bool(torch.equal(k[held], kp)),
                  "ck_bit_equal": bool(torch.equal(kt.twin_checkpoints(ck, 39, 39, P, held),
                                                   ckp)),
                  "dz_scaled_err": ((dz[..., held] - dzp).abs().max()
                                    / dzp.abs().max()).item()})
        for _ in range(2):
            times[name]["fwd_values_ms"].append(event_ms(lambda: kt.tiled_forward(z, False)))
            times[name]["fwd_ms"].append(event_ms(lambda: kt.tiled_forward(z, True)))
            times[name]["bwd_ms"].append(event_ms(lambda: kt.tiled_backward(z, ck, g)))
        del ck, dz
    kt._lib = lambda: tree
    for name in libs:
        emit({"variant": name, "pairs": P, "shape": [1024, 40, 2],
              **{k: statistics.median(v) for k, v in times[name].items()},
              "samples": times[name]})
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
