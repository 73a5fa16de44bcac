"""Build and load the port's hand-written CUDA kernels.

Every ``sigsvgd_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with ctypes.
The libraries go to ``build/kernels/`` at the repository root, named by a
hash of their source, so a changed source is rebuilt and an unchanged one is
reused. Nothing builds at import: the first call to :func:`load` builds all
sources, one ``nvcc`` process each, started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA machine")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build_all() -> Dict[str, str]:
    """Compile every stale source, all in parallel. Returns the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) of every
    source, kept beside its library when it was built, so a library built
    by an earlier process reports as one built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    sources = sorted(CSRC.glob("*.cu"))
    for src in sources:
        out = _lib_path(src)
        if out.exists() and _report_path(out).exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    for stem, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu:\n{text}")
        _report_path(out).write_text(text)
        os.replace(tmp, out)
    return {src.stem: _report_path(_lib_path(src)).read_text() for src in sources}


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    path = _lib_path(CSRC / f"{stem}.cu")
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))
