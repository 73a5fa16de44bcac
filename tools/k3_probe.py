"""Where K3 spends its time: copies of its source with one part cut, and
its band rows swept.

    python3 tools/k3_probe.py [--parent FILE] [--out FILE]

Builds ``sigsvgd_tpu_torch/csrc/sigkernel_block.cu`` as it is and copies of
it, each changed by a textual edit: ``statics_only`` (a cell adds its z to
the K below it instead of the update: the statics, z and one add a cell
remain, no chain along a row), ``sweep_only`` (a static node is -½|x'|² -
½|y'|² without the cross product and the exp: the sweep remains), ``mb4``
(launch bounds of 16 warps an SM at every bucket: at most 128 registers) and ``R1``, ``R3``, ``R4``, ``R6``, ``R8`` (bands of that many
cell rows at every bucket; the kernel's are 2 up to 40 nodes, 4 at 64). The cuts give a wrong K on purpose and only their times
count; each band-row variant and ``mb4`` must give the kernel's K bit for
bit.
``--parent`` adds an earlier K3 source of the one-thread-a-row interface
(``sigkernel_block_gram(X, h, K, n, L, C, stream)``, the one before the
band wavefront), timed and held against the kernel the same way.

Each runs at [1024, 40, 2] on ``chip_smoke.py``'s seeded smooth paths at
h = 4 (524,800 pairs), timed by CUDA events, 3 calls a sample, in the
order kernel, variants, variants reversed, kernel, and each but the
parent also at [1024, 16, 8] (τ-like knots). The kernel is held against the twin (K bit for bit) and
across two calls. Reported: the ptxas figures (registers, spill bytes,
stack frame) of every function of every copy; where ``cuobjdump`` is found,
the instructions of the [40, 2] instantiation of each copy's K3 by opcode,
the band loop's body (the longest backward branch) and the instructions a
pair that implies (``body × bands + the rest``); from those the issue floor
(one instruction a cycle on each of the card's 528 sub-partitions at its
maximum SM clock, for the warps that hold a pair a ≤ b) and the share of
that rate each copy reaches. The cuts are exact lines of the source: after
an edit of those lines the probe stops with the cut's name, and ``CUTS``
must follow the source. One JSON line a measurement (also to ``FILE``,
default ``build/k3_probe.jsonl``). Needs a CUDA card; imports nothing of JAX.
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
SRC = ROOT / "sigsvgd_tpu_torch" / "csrc" / "sigkernel_block.cu"
BUILD = ROOT / "build" / "k3_probe"

_RV = "__host__ __device__ constexpr int band_rows() { return LMAX <= 40 ? 2 : 4; }"
CUTS = {
    "statics_only": [("          const float kn = cell(kr[s][j] + kd1, kd0, q);",
                      "          const float kn = kd1 + q.z;")],
    "sweep_only": [("  return expf(__fadd_rn(cross, __fadd_rn(y[C], x[C])));",
                    "  return __fadd_rn(y[C], x[C]);")],
    "mb4": [("__host__ __device__ constexpr int values_min_blocks() { return LMAX <= 16 ? 4 : 3; }",
             "__host__ __device__ constexpr int values_min_blocks() { return 4; }")],
    **{f"R{r}": [(_RV, _RV.replace("LMAX <= 40 ? 2 : 4;", f"{r};"))] for r in (1, 3, 4, 6, 8)},
}
BAND_ROWS = {"kernel": 2, "statics_only": 2, "sweep_only": 2, "mb4": 2,
             **{f"R{r}": r for r in (1, 3, 4, 6, 8)}}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an earlier K3 source (one thread a row)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k3_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    base = SRC.read_text()
    sources = {"kernel": base}
    for name, edits in CUTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"k3_probe: the {name} cut no longer matches {SRC.name}")
            text = text.replace(old, new)
        sources[name] = text
    if args.parent:
        sources["parent"] = args.parent.read_text()
    libs = build(sources)
    import chip_smoke as cs
    import sigsvgd_tpu_torch  # noqa: F401  (the fp32 matmul policy)
    from sigsvgd_tpu_torch.kernels import sigkernel_block as kb

    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    n, L, C, h = 1024, 40, 2, 4.0
    plan = kb.block_values_plan(n, L, C)
    tag = "block_values_kernelILi40ELi2E"
    sass = {name: cs.sass_counts(lib, tag) for name, (_, lib, _) in libs.items()}
    floor = {name: cs.k3_issue_floor(n, s, L - 1 if name == "parent"
                                     else -(-(L - 1) // BAND_ROWS[name]))
             for name, s in sass.items()}
    emit({"card": smi, "shape": [n, L, C], "plan": vars(plan), "sass": sass, "floor": floor,
          "ptxas": {name: cs.ptxas_functions(report) for name, (_, _, report) in libs.items()}})

    tree = kb._lib()
    for name, (lib, _, _) in libs.items():
        fn = lib.sigkernel_block_gram
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                       if name == "parent" else tree.sigkernel_block_gram.argtypes)

    gen = torch.Generator(device="cuda").manual_seed(3)
    X = cs.smooth_paths(n, L, C, gen)
    X8 = cs.smooth_paths(1024, 16, 8, gen)
    h_t = torch.tensor([h], device="cuda")

    def call(name, Xc):
        nn_, LL, CC = Xc.shape
        K = torch.empty(nn_, nn_, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        lib = libs[name][0]
        if name == "parent":
            rc = lib.sigkernel_block_gram(Xc.data_ptr(), h_t.data_ptr(), K.data_ptr(), nn_, LL,
                                          CC, stream)
        else:
            tl = kb._tile_list(nn_, kb.VALUES_TILE_COLS, "cuda")
            rc = lib.sigkernel_block_gram(Xc.data_ptr(), h_t.data_ptr(), tl.data_ptr(),
                                          tl.shape[0], K.data_ptr(), nn_, LL, CC, stream)
        if rc:
            raise RuntimeError(f"{name}: cudaError {rc}")
        return K

    Kt = kb.block_gram_plain(X, h)
    Kk = call("kernel", X)
    again = call("kernel", X)
    K8, K8p = call("kernel", X8), kb.block_gram_plain(X8, h)
    torch.cuda.synchronize()
    emit({"check": "kernel against the twin", "bit_equal_twin": bool(torch.equal(Kk, Kt)),
          "bit_equal_across_calls": bool(torch.equal(Kk, again)),
          "k_max_abs_err": (Kk - Kt).abs().max().item(),
          "c8_bit_equal_twin": bool(torch.equal(K8, K8p))})
    sha = {}
    for name in libs:
        if name in ("parent", "mb4") or name.startswith("R"):
            Kv = call(name, X)
            torch.cuda.synchronize()
            sha[name] = bool(torch.equal(Kv, Kk))
    emit({"check": "band-row variants and the parent against the kernel", "bit_equal": sha})

    times = {name: [] for name in libs}
    times8 = {name: [] for name in libs if name != "parent"}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        call(name, X)
        torch.cuda.synchronize()
        for _ in range(2):
            times[name].append(cs.event_ms(lambda: call(name, X), 3))
            if name in times8:
                times8[name].append(cs.event_ms(lambda: call(name, X8), 3))
    for name in libs:
        ms = statistics.median(times[name])
        row = {"variant": name, "shape": [n, L, C], "ms": ms, "samples": times[name],
               "band_rows": BAND_ROWS.get(name)}
        if name in times8:
            row.update(ms_1024x16x8=statistics.median(times8[name]),
                       samples_1024x16x8=times8[name])
        f = floor[name]
        if f["issue_floor_ms"] is not None:
            row.update(per_pair=f["sass_per_pair"], issue_floor_ms=f["issue_floor_ms"],
                       share_of_issue_rate=f["issue_floor_ms"] / ms)
        emit(row)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
