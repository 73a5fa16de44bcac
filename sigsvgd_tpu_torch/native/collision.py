"""ctypes bindings of the repository's C++ mesh collision engine (port of
``sigsvgd_tpu/native/collision.py``).

``native/collision/collision.cpp`` answers exact STL-mesh distance queries
over a BVH: point to mesh, and mesh to mesh under rigid poses. It runs on
the host, for trajectory audits and for the mesh obstacles' distance grids.
The first use builds it with ``g++ -O3 -march=native -shared -fPIC`` into
``build/native/`` at the repository root, named by a hash of the source and
the flags and the host's CPU (nothing is written beside the source);
a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "native" / "collision" / "collision.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _host_cpu() -> str:
    """The host's CPU model and flags: ``-march=native`` code built on one
    CPU may not run on another, so the library's name carries them."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine()
    keys = ("model name", "flags")
    return "|".join(next((ln for ln in lines if ln.startswith(k)), "") for k in keys)


def library_path() -> Path:
    key = SRC.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_cpu().encode()
    return BUILD_DIR / f"libcollision-{hashlib.sha1(key).hexdigest()[:12]}.so"


def build_native_library() -> Path:
    """The shared library, compiled first if this source has none yet."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native collision engine cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_library()))
    fptr, vptr = ctypes.POINTER(ctypes.c_float), ctypes.c_void_p
    lib.mesh_load_stl.restype = vptr
    lib.mesh_load_stl.argtypes = [ctypes.c_char_p]
    lib.mesh_free.argtypes = [vptr]
    lib.mesh_num_triangles.restype = ctypes.c_int
    lib.mesh_num_triangles.argtypes = [vptr]
    lib.mesh_get_triangles.argtypes = [vptr, fptr]
    lib.mesh_point_distances.argtypes = [vptr, fptr, ctypes.c_int, fptr]
    lib.mesh_point_distances_tf.argtypes = [vptr, fptr, fptr, ctypes.c_int, fptr]
    lib.mesh_mesh_distance.restype = ctypes.c_float
    lib.mesh_mesh_distance.argtypes = [vptr, fptr, vptr, fptr, ctypes.c_float]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rigid(transform) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(transform, np.float32)[:3, :4])


class TriMesh:
    """A loaded STL mesh with its BVH (owned by the native library)."""

    def __init__(self, path: str | Path):
        self._lib = _lib()
        self._handle = self._lib.mesh_load_stl(str(path).encode())
        if not self._handle:
            raise FileNotFoundError(f"failed to load STL mesh: {path}")
        self.path = str(path)

    @property
    def n_triangles(self) -> int:
        return self._lib.mesh_num_triangles(self._handle)

    def triangles(self) -> np.ndarray:
        """``[n_tris, 3, 3]`` vertex array."""
        out = np.empty((self.n_triangles, 9), np.float32)
        self._lib.mesh_get_triangles(self._handle, _fptr(out))
        return out.reshape(-1, 3, 3)

    def surface_points(self, n: int, seed: int = 0) -> np.ndarray:
        """Area-weighted uniform samples on the surface ``[n, 3]`` (numpy's
        generator seeded with ``seed``, the JAX package's draws)."""
        tris = self.triangles().astype(np.float64)
        ab = tris[:, 1] - tris[:, 0]
        ac = tris[:, 2] - tris[:, 0]
        areas = 0.5 * np.linalg.norm(np.cross(ab, ac), axis=-1)
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(tris), size=n, p=areas / areas.sum())
        u = rng.random(n)
        v = rng.random(n)
        flip = u + v > 1
        u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
        pts = tris[idx, 0] + u[:, None] * ab[idx] + v[:, None] * ac[idx]
        return pts.astype(np.float32)

    def point_distances(self, pts: np.ndarray,
                        transform: Optional[np.ndarray] = None) -> np.ndarray:
        """Unsigned distances from world points ``[n, 3]`` to the mesh; with
        ``transform`` (``[3or4, 4]`` rigid world-from-mesh) the points are
        pulled into the mesh frame."""
        pts = np.ascontiguousarray(pts, np.float32).reshape(-1, 3)
        out = np.empty(pts.shape[0], np.float32)
        if transform is None:
            self._lib.mesh_point_distances(self._handle, _fptr(pts), pts.shape[0], _fptr(out))
        else:
            t = _rigid(transform)
            self._lib.mesh_point_distances_tf(self._handle, _fptr(t), _fptr(pts),
                                              pts.shape[0], _fptr(out))
        return out

    def distance_to(self, other: "TriMesh", transform_self: np.ndarray,
                    transform_other: np.ndarray, stop_below: float = 0.0) -> float:
        """Least distance between this mesh and ``other`` under rigid
        transforms (``[3or4, 4]``); stops early below ``stop_below``."""
        t1, t2 = _rigid(transform_self), _rigid(transform_other)
        return float(self._lib.mesh_mesh_distance(self._handle, _fptr(t1), other._handle,
                                                   _fptr(t2), stop_below))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mesh_free(handle)
            self._handle = None


class MeshCollisionEngine:
    """Mesh-level collision queries for an articulated robot: its collision
    STLs are loaded once, and link pairs are checked under poses."""

    def __init__(self, mesh_paths: Dict[str, str]):
        self.meshes = {name: TriMesh(p) for name, p in mesh_paths.items()}

    @staticmethod
    def _pose_matrix(pos: np.ndarray, rot: np.ndarray) -> np.ndarray:
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = rot
        t[:3, 3] = pos
        return t

    def pairwise_distance(self, link_a: str, pose_a: Tuple[np.ndarray, np.ndarray],
                          link_b: str, pose_b: Tuple[np.ndarray, np.ndarray],
                          stop_below: float = 0.0) -> float:
        ta = self._pose_matrix(*pose_a)
        tb = self._pose_matrix(*pose_b)
        return self.meshes[link_a].distance_to(self.meshes[link_b], ta, tb, stop_below)

    def points_min_distance(self, link: str, pose: Tuple[np.ndarray, np.ndarray],
                            pts: np.ndarray) -> np.ndarray:
        return self.meshes[link].point_distances(pts, self._pose_matrix(*pose))
