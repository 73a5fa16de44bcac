"""Where K6 and K4's forward and backward spend their time: copies of their
source with one part cut.

    python3 tools/k6_probe.py [--also NAME=FILE ...] [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/sigkernel_fused.cu`` as it is and copies of
it, each with one part cut by a textual edit (so the cut kernel's output is
wrong on purpose and only its times count). K6: ``k6_chains_only`` (the
three delta chains alone: no exp of the statics, no pull-back),
``k6_no_pull_back``, ``k6_no_prefetch`` (no checkpoint row is copied into
the stage: anchored bands start from a stale row) and ``k6_handoff_only``
(no unit is processed: the stage reads, the copies and the hand-off's
shuffles alone). K4's forward: ``fwd_statics_only`` (the static rows, z, A
and B of every band, no sweep and no residual store), ``fwd_no_ck_stores``
(the right edges still written) and ``fwd_no_residual_stores``. K4's
backward: ``bwd_chains_only`` (the adjoint, the rebuild toward -j and the
dz sums alone: no exp of the statics, no pull-back), ``bwd_no_pull_back``,
``bwd_no_prefetch`` (no checkpoint row is copied into the stage: anchored
bands start from a stale row) and ``bwd_handoff_only`` (no band is swept:
the stage reads, the copies, the lower static row and the hand-off's
shuffles alone). A cut
disables its part with a condition that is false only at run time, so the
kernel compiles as it is and the cut part's inputs stay live. ``--also``
adds other sources of the same C interface to time beside them. Each runs
at the flagship pair list, the upper triangle of ``chip_smoke.py``'s seeded
smooth [1024, 40, 2] paths at h = 4 (524,800 pairs; K6 on the tree's own
forward residuals), timed by CUDA events, 3 calls a sample, in the order
kernel, cuts, cuts reversed, kernel. The kernel as it is, and each
``--also`` source, is held against the twins on the first and last 4,096
pairs (k, ck and rc bit for bit; K6 rel and cos; K4's backward scaled
against the twin in fp64, and bit for bit across two calls). The ptxas
figures (registers, spill bytes, stack frame) of every function of every
copy are reported, and where ``cuobjdump`` is found the instructions of the
flagship's instantiations (span 5, C = 2) of the three kernels in the
kernel's SASS are counted by kind. The cuts are exact lines of the source: after an edit of those
lines the probe stops with the cut's name, and its ``CUTS`` must follow the
source. One JSON line a measurement (also to ``FILE``, default
``build/k6_probe.jsonl``). Needs a CUDA card; imports nothing of JAX.
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
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "sigkernel_fused.cu"
BUILD = ROOT / "build" / "k6_probe"

_K6_PULL = ("              pull_back<C>(__fmul_rn(__fsub_rn(dz, dz_r[i]), ZS), gu_r[i], "
            "gd_r[i], yr,",
            "              if (lx1 < 0) pull_back<C>(__fmul_rn(__fsub_rn(dz, dz_r[i]), ZS), "
            "gu_r[i], gd_r[i], yr,")
_K6_PULL0 = ("            pull_back<C>(__fmul_rn(-dz_r[i], ZS), gu_r[i], gd_r[i], y0, "
             "dys + i * NT, 2 * NT,",
             "            if (lx1 < 0) pull_back<C>(__fmul_rn(-dz_r[i], ZS), gu_r[i], gd_r[i], "
             "y0, dys + i * NT, 2 * NT,")
_BWD_PULL = ("            pull_back<C>(__fsub_rn(dinc, dinc_r), gs[kk + 1], gd[kk + 1], yq,",
             "            if (lx1 < 0) pull_back<C>(__fsub_rn(dinc, dinc_r), gs[kk + 1], "
             "gd[kk + 1], yq,")
_BWD_PULL0 = ("          pull_back<C>(-dinc_r, gs[0], gd[0], y0, dys, NT, xu, xd, sxu, sxd, "
              "swu, swd);",
              "          if (lx1 < 0) pull_back<C>(-dinc_r, gs[0], gd[0], y0, dys, NT, xu, xd, "
              "sxu, sxd, swu, swd);")
_RES = ("          const bool keep = ck != nullptr && ck_band(b, lx1, bpc);",
        "          const bool keep = ck != nullptr && ck_band(b, lx1, bpc) && lx1 < 0;")
CUTS = {
    "k6_chains_only": [
        ("""              gu_l[i] = gval<C>(xu[i], yl);
              gd_l[i] = gval<C>(xd[i], yl);""",
         """              gu_l[i] = lx1 < 0 ? gval<C>(xu[i], yl) : yl[0];
              gd_l[i] = lx1 < 0 ? gval<C>(xd[i], yl) : yl[C - 1];"""), _K6_PULL, _K6_PULL0],
    "k6_no_pull_back": [_K6_PULL, _K6_PULL0],
    "k6_no_prefetch": [("""      if (ck_band(b, lx1, bpc)) {
        const float* row = ck + (size_t)(b / bpc) * G1 * P;
""", """      if (ck_band(b, lx1, bpc) && lx1 < 0) {
        const float* row = ck + (size_t)(b / bpc) * G1 * P;
""")],
    "k6_handoff_only": [("""      if (mine) {
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const int cc = c0 + kk;""", """      if (mine && lx1 < 0) {
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const int cc = c0 + kk;""")],
    "fwd_statics_only": [("              gu0 = gu1;\n",
                          "              gu0 = gu1;\n              if (lx1 > 0) {\n"
                          "                left[0] += q.A - q.B;\n                continue;\n"
                          "              }\n")],
    "fwd_no_ck_stores": [_RES],
    "fwd_no_residual_stores": [_RES, ("            if (rc != nullptr) {",
                                      "            if (rc != nullptr && lx1 < 0) {")],
    "bwd_chains_only": [("\n            gd[q] = gval<C>(xd, yq);",
                         "\n            gd[q] = lx1 < 0 ? gval<C>(xd, yq) : yq[0];"),
                        ("              gs[q] = gval<C>(xu, yq);",
                         "              gs[q] = lx1 < 0 ? gval<C>(xu, yq) : yq[C - 1];"),
                        _BWD_PULL, _BWD_PULL0],
    "bwd_no_pull_back": [_BWD_PULL, _BWD_PULL0],
    "bwd_no_prefetch": [("""      if (ck_band(b, lx1, bpc)) {
        const float* row = ck + (size_t)(b / bpc) * G1 * P + p;""",
                         """      if (ck_band(b, lx1, bpc) && lx1 < 0) {
        const float* row = ck + (size_t)(b / bpc) * G1 * P + p;""")],
    "bwd_handoff_only": [("""      if (mine) {
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const Coef q =""", """      if (mine && lx1 < 0) {
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const Coef q =""")],
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
    """Instructions of the flagship's instantiations (span 5, C = 2) of K4's
    forward and backward and K6 in ``lib``'s SASS, by opcode (the 12 most
    frequent) and in all."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        which = re.search(r"fused_(fwd|bwd|bwd_bf16)_lanes_kernelILi5ELi2E", name)
        if which:
            ops = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part))
            out[which.group(1)] = {"all": sum(ops.values()), **dict(ops.most_common(12))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=FILE: another source of the same C interface to time")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k6_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device; nothing was run", file=sys.stderr)
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
                raise SystemExit(f"k6_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)
    import chip_smoke as cs
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"card": smi, "sass": sass_counts(libs["kernel"][1]),
          "ptxas": {name: cs.ptxas_functions(report) for name, (_, _, report) in libs.items()}})
    tree = kf._lib()
    fns = ("sigkernel_fused_resident", "sigkernel_fused_fwd", "sigkernel_fused_bwd",
           "sigkernel_fused_bwd_bf16")
    for lib, _, _ in libs.values():
        for fn in fns:
            getattr(lib, fn).argtypes = getattr(tree, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(4)
    xt, yt, g = cs.triu_tiles(cs.smooth_paths(1024, 40, 2, gen), 4.0)[:3]
    P = xt.shape[2]
    _, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    held = torch.cat([torch.arange(4096, device="cuda"), torch.arange(P - 4096, P, device="cuda")])
    sl = (xt[..., held], yt[..., held])
    kp, ckp, rcp = kf.fused_forward_plain(*sl, residuals=True)
    dxp, dyp = kf.fused_backward_bf16_plain(*sl, ckp, rcp, g[held])
    twin = torch.cat([dxp.flatten(), dyp.flatten()])
    del dxp, dyp
    _, dx64, dy64 = cs.twin_in_chunks(
        lambda a, b, c: kf.fused_pairs_plain(a.double(), b.double(), c.double()), *sl, g[held],
        2048)

    def use(lib):
        kf._lib = lambda: lib
        kf.resident_blocks.cache_clear()

    times = {name: collections.defaultdict(list) for name in libs}
    order = list(libs) + list(libs)[::-1]
    checked = set()
    for name in order:
        use(libs[name][0])
        kf.fused_forward(xt, yt, residuals=True)
        kf.fused_backward_bf16(xt, yt, ck, rc, g)
        kf.fused_backward(xt, yt, ck, rc, g)
        torch.cuda.synchronize()
        if (name == "kernel" or name in also) and name not in checked:
            checked.add(name)
            k, ck2, rc2 = kf.fused_forward(xt, yt, residuals=True)
            dx, dy = kf.fused_backward_bf16(xt, yt, ck, rc, g)
            rel, cos = cs.rel_cos(torch.cat([dx[..., held].flatten(), dy[..., held].flatten()]),
                                  twin)
            dx32, dy32 = kf.fused_backward(xt, yt, ck, rc, g)
            again = kf.fused_backward(xt, yt, ck, rc, g)
            emit({"check": f"{name} against the twins", "pairs_held": held.numel(),
                  "k_bit_equal": bool(torch.equal(k[held], kp)),
                  "ck_bit_equal": bool(torch.equal(ck2[..., held], ckp)),
                  "rc_bit_equal": bool(torch.equal(rc2[..., held], rcp)),
                  "k6_rel": rel, "k6_cos": cos,
                  "k4_bwd_dx_scaled_err_vs_fp64": cs.scaled_err(dx32[..., held], dx64),
                  "k4_bwd_dy_scaled_err_vs_fp64": cs.scaled_err(dy32[..., held], dy64),
                  "k4_bwd_bit_equal_across_calls": bool(torch.equal(dx32, again[0])
                                                        and torch.equal(dy32, again[1]))})
            del k, ck2, rc2, dx, dy, dx32, dy32, again
        for _ in range(2):
            times[name]["fwd_ms"].append(
                cs.event_ms(lambda: kf.fused_forward(xt, yt, residuals=True), 3))
            times[name]["fwd_values_ms"].append(
                cs.event_ms(lambda: kf.fused_forward(xt, yt, residuals=False), 3))
            times[name]["k6_ms"].append(
                cs.event_ms(lambda: kf.fused_backward_bf16(xt, yt, ck, rc, g), 3))
            times[name]["k4_bwd_ms"].append(
                cs.event_ms(lambda: kf.fused_backward(xt, yt, ck, rc, g), 3))
    use(tree)
    for name in libs:
        emit({"variant": name, "pairs": P, "shape": [1024, 40, 2],
              **{k: statistics.median(v) for k, v in times[name].items()},
              "samples": times[name]})
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
