"""K6's plain twin against the JAX package's bf16 VJP at the flagship path
length: [5, 40, 2] paths of the card tests' kind (cumulative sums of
uniform ±0.1 steps), h = 4, 128 random pairs at the head of one 2048-pair
tile and the rest the JAX contract's padding (index 0, cotangent 0), as
``test_torch_fused.py::test_k4_twin_matches_jax_at_the_flagship_path_length``
takes them for K4. Along 312 fine columns the bf16 chains drift; the test
at [6, 5, 2] in ``test_torch_fused.py`` spans one checkpoint segment only.

The JAX side runs in a child process with ``--xla_allow_excess_precision=
false``. By default XLA's CPU compiler may carry a chain of bf16 operations
in fp32 and round once at its end, where the TPU kernel and the twin round
every operation; the flag makes the interpret-mode kernel round as they do.
It must be set before JAX's CPU backend starts, hence the child.

Held: the twin's gradient within rel 1e-2 of JAX's bf16 gradient, and its
distance from JAX's fp32 gradient of the same pairs equal to the distance of
JAX's own bf16 gradient within 5e-3, so that the bf16 route's error on these
paths is the delta-form method's, not the port's.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from sigsvgd_tpu.kernels import pallas_sigkernel as jps
from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

_ROOT = pathlib.Path(__file__).resolve().parents[1]

_JAX_VJPS = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from sigsvgd_tpu.kernels import pallas_sigkernel as jps

d = np.load(sys.argv[1])
ix, iy = jnp.asarray(d["ix"], jnp.int32), jnp.asarray(d["iy"], jnp.int32)
out = {}
for prec in ("bf16", "fp32"):
    _, vjp = jax.vjp(lambda x, y: jps.pallas_pair_gram_fused(
        x, y, ix, iy, float(d["h"]), grad_precision=prec),
        jnp.asarray(d["X"]), jnp.asarray(d["X"]))
    dx, dy = vjp(jnp.asarray(d["g"]))
    out[prec] = np.asarray(dx) + np.asarray(dy)  # X serves as both paths
np.savez(sys.argv[2], **out)
"""


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_k6_twin_matches_jax_bf16_vjp_at_the_flagship_path_length(tmp_path):
    rng = np.random.default_rng(3)
    n, L, C, real, h = 5, 40, 2, 128, 4.0
    X = np.cumsum((rng.random((n, L, C)) - 0.5) * 0.2, axis=1).astype(np.float32)
    ix = np.zeros(jps._P, np.int64)
    iy = np.zeros(jps._P, np.int64)
    ix[:real], iy[:real] = rng.integers(0, n, real), rng.integers(0, n, real)
    g = np.zeros(jps._P, np.float32)
    g[:real] = rng.standard_normal(real)

    np.savez(tmp_path / "in.npz", X=X, ix=ix, iy=iy, g=g, h=h)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(_ROOT), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _JAX_VJPS, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], env=env, cwd=_ROOT, check=True,
                   timeout=600, capture_output=True)
    jax_grads = np.load(tmp_path / "out.npz")

    Xt = torch.from_numpy(X).requires_grad_(True)
    k = kf.pair_gram_fused(Xt, Xt, torch.from_numpy(ix[:real]), torch.from_numpy(iy[:real]),
                           h, "bf16")
    (d16,) = torch.autograd.grad(k, Xt, torch.from_numpy(g[:real]))
    d16 = d16.numpy()
    assert _rel(d16, jax_grads["bf16"]) < 1e-2
    assert abs(_rel(d16, jax_grads["fp32"]) - _rel(jax_grads["bf16"], jax_grads["fp32"])) < 5e-3
