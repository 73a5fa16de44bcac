"""K9's precision plan and chunk plan, checked on the CPU.

K9 (``csrc/svgd_velocity.cu``) runs all three of its products (X·Xᵀ, K·s,
K·x) on the tensor cores in 3xTF32: each operand splits into
``hi = tf32(a)`` and ``lo = tf32(a − hi)`` and a product accumulates
``lo·hi + hi·lo + hi·hi`` in fp32. No card runs here, so a numpy emulation
of that rounding stands in for the kernel and is held against JAX's
``xla_rbf_velocity`` and the port's twin at K9's tolerance, rtol 2e-4 and
atol 5e-5 (``tests/test_pallas_svgd.py``). The emulation walks the chunks of
:func:`velocity_plan` as the kernel's dispatcher does.

Why K·[s | x] is not single-pass TF32: with scores of unit size φ is so
small that the atol hides TF32's 10-bit mantissa (2.1e-6 from the twin at
[1024, 280]), but with scores 100 times larger single-pass TF32 on K·[s | x]
lands 2.5e-4 from the twin, 1.5e-4 beyond the tolerance, and 3xTF32 1.1e-6
(these tests' inputs).

The tensor cores add with truncation, and the emulation above sums each
product exactly. :func:`mm_3xtf32_truncating` models that accumulator as
the kernel drives it; the last test holds the kernel's flushed chains
against a whole-k-axis chain with it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels.pallas_svgd import xla_rbf_velocity
from sigsvgd_tpu_torch.kernels import svgd_velocity as kv
from sigsvgd_tpu_torch.utils.math import bw_median, pw_dist_sq

K9_TOL = dict(rtol=2e-4, atol=5e-5)


def tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from 0."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ah = tf32(a)
    al = tf32(a - ah)
    bh = tf32(b)
    bl = tf32(b - bh)
    c = al @ bh
    c += ah @ bl
    c += ah @ bh
    return c


def _rz32(v: np.ndarray) -> np.ndarray:
    """fp64 to fp32, rounded toward zero."""
    y = v.astype(np.float32)
    return np.where(np.abs(y) > np.abs(v), np.nextafter(y, np.float32(0)), y)


def mm_3xtf32_truncating(a: np.ndarray, b: np.ndarray, flush_slices=2) -> np.ndarray:
    """3xTF32 with the kernel's chains and a truncating accumulator. The
    k axis runs in 32-wide slices, each split in two 16-wide halves (the
    two warps' k-halves, summed at the end); each ``mma.sync`` k8 issues its
    8 products in blocks of 4, and a block adds to the running sum as the
    tensor cores are modelled here: every addend truncated at the largest
    one's fp32 quantum, the sum truncated to fp32. Every ``flush_slices``
    slices (None: never) the running sum leaves for an fp32 add, rounded to
    nearest. NVIDIA does not document the accumulator: the block width and
    the bits kept are this model's assumptions."""
    K = a.shape[1]
    ah = tf32(a)
    al = tf32(a - ah)
    bh = tf32(b)
    bl = tf32(b - bh)
    ah, al, bh, bl = (v.astype(np.float64) for v in (ah, al, bh, bl))
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for kw in range(2):
        acc = np.zeros_like(out)
        part = np.zeros_like(out)
        for sl in range(-(-K // 32)):
            for k0 in range(32 * sl + 16 * kw, min(32 * sl + 16 * kw + 16, K), 8):
                for u, v in ((al, bh), (ah, bl), (ah, bh)):
                    for b0 in range(k0, min(k0 + 8, K), 4):
                        k = slice(b0, min(b0 + 4, K))
                        p = u[:, k].T[:, :, None] * v[k][:, None, :]
                        c = part.astype(np.float64)
                        big = np.maximum(np.abs(c), np.abs(p).max(axis=0))
                        q = np.ldexp(1.0, np.frexp(big)[1] - 24)
                        part = _rz32(np.trunc(c / q) * q + (np.trunc(p / q) * q).sum(axis=0))
            if flush_slices and sl % flush_slices == flush_slices - 1:
                acc += part
                part[:] = 0
        out += acc + part
    return out


def mm_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32(a) @ tf32(b)


def emulated_k9(x, s, h, plan, apply_mm=mm_3xtf32):
    """φ as K9 rounds it, chunk by chunk in ``plan``'s order: kernel A's
    Gram and its epilogue, kernel B's K·[s | x], row sums and term, added
    into φ over column chunks and divided by N after the last."""
    N, D = x.shape
    x = (x - x.mean(0, dtype=np.float32)).astype(np.float32)
    nrm = np.einsum("ij,ij->i", x, x).astype(np.float32)
    h2 = np.float32(h) * np.float32(h)
    phi = np.zeros((N, D), np.float32)
    for r0 in range(0, N, plan.rows):
        rr = slice(r0, min(r0 + plan.rows, N))
        for c0 in range(0, N, plan.cols):
            cc = slice(c0, min(c0 + plan.cols, N))
            G = mm_3xtf32(x[rr], x[cc].T)
            d2 = np.maximum(nrm[rr, None] + nrm[None, cc] - np.float32(2) * G, np.float32(0))
            K = np.exp(np.float32(-0.5) * d2 / h2).astype(np.float32)
            V = apply_mm(K, np.concatenate([s[cc], x[cc]], axis=1))
            r = K.sum(axis=1, dtype=np.float32)[:, None]
            phi[rr] += V[:, :D] - (V[:, D:] - r * x[rr]) / h2
    return phi / np.float32(N)


def _inputs(rng, N, D, scale):
    """Policies as the solve holds them (uniform in ±2), scores ``randn ×
    scale`` and the sampler's median bandwidth."""
    x = rng.uniform(-2.0, 2.0, (N, D)).astype(np.float32)
    s = (rng.standard_normal((N, D)) * scale).astype(np.float32)
    xt = torch.from_numpy(x)
    h = float(bw_median(pw_dist_sq(xt, xt)))
    return x, s, h


def _twin(x, s, h):
    return kv.rbf_velocity_plain(torch.from_numpy(x), torch.from_numpy(s),
                                 torch.tensor(h)).numpy()


@pytest.mark.parametrize("N,D,scale", [(1024, 280, 1.0), (1024, 280, 100.0),
                                       (256, 1400, 1.0)])
def test_3xtf32_emulation_matches_jax_and_twin(rng, N, D, scale):
    x, s, h = _inputs(rng, N, D, scale)
    got = emulated_k9(x, s, h, kv.velocity_plan(N, D))
    ref = np.asarray(xla_rbf_velocity(jnp.asarray(x), jnp.asarray(s), jnp.asarray(h)))
    np.testing.assert_allclose(got, ref, **K9_TOL)
    np.testing.assert_allclose(got, _twin(x, s, h), **K9_TOL)


def test_single_pass_tf32_apply_misses_the_tolerance_at_scaled_scores(rng):
    """The scaled-score case has teeth: TF32 on K·[s | x] (the distances
    still in 3xTF32) fails it where 3xTF32 passes."""
    x, s, h = _inputs(rng, 1024, 280, 100.0)
    want = _twin(x, s, h)
    plan = kv.velocity_plan(1024, 280)
    for apply_mm, passes in ((mm_3xtf32, True), (mm_tf32, False)):
        err = np.abs(emulated_k9(x, s, h, plan, apply_mm) - want)
        excess = (err - (K9_TOL["atol"] + K9_TOL["rtol"] * np.abs(want))).max()
        assert (excess <= 0) == passes, (apply_mm.__name__, err.max(), excess)


@pytest.mark.parametrize("N,D,row_chunks,col_chunks", [
    (1024, 280, 1, 1), (1024, 1400, 1, 1), (12000, 7, 19, 1), (1, 1, 1, 1),
    (1 << 20, 7, 365, 365)])
def test_velocity_plan_covers_the_gram_inside_the_cap(N, D, row_chunks, col_chunks):
    p = kv.velocity_plan(N, D)
    assert (p.row_chunks, p.col_chunks) == (row_chunks, col_chunks)
    rpad, cpad = -(-p.rows // 64) * 64, -(-p.cols // 64) * 64
    assert p.scratch_bytes == 4 * rpad * cpad <= kv.CHUNK_BYTES
    # the chunks cover N × N, and the last of each starts inside it
    assert (p.row_chunks - 1) * p.rows < N <= p.row_chunks * p.rows
    assert (p.col_chunks - 1) * p.cols < N <= p.col_chunks * p.cols
    assert p.blocks_gram == (cpad // 64) * (rpad // 64)
    assert p.blocks_apply == -(-D // 32) * (rpad // 64)
    if (N, D) == (1024, 280):  # the policy solve: 256 Gram tiles, 16 × 9 blocks
        assert (p.rows, p.cols, p.blocks_gram, p.blocks_apply) == (1024, 1024, 256, 144)


def test_chunked_walk_matches_the_twin(rng, monkeypatch):
    """Row and column chunks (a 64 KiB cap: 128 × 128 chunks of N = 300)
    give the one-chunk φ: the terms add over column chunks."""
    x, s, h = _inputs(rng, 300, 37, 1.0)
    monkeypatch.setattr(kv, "CHUNK_BYTES", 64 << 10)
    plan = kv.velocity_plan(300, 37)
    assert (plan.rows, plan.cols, plan.row_chunks, plan.col_chunks) == (128, 128, 3, 3)
    monkeypatch.setattr(kv, "CHUNK_BYTES", 96 << 10)
    row_plan = kv.velocity_plan(300, 37)
    assert (row_plan.rows, row_plan.cols, row_plan.row_chunks,
            row_plan.col_chunks) == (64, 300, 5, 1)
    want = _twin(x, s, h)
    for p in (plan, row_plan):
        np.testing.assert_allclose(emulated_k9(x, s, h, p), want, **K9_TOL)
    monkeypatch.setattr(kv, "CHUNK_BYTES", 1 << 12)
    with pytest.raises(ValueError, match="no 64 × 64 tile"):
        kv.velocity_plan(300, 37)


def test_truncating_accumulator_needs_the_flush(rng):
    """With scores × 100, K·[s | x] in the kernel's chains (a flush every
    second slice) stays about as close to fp64 as the fp32 twin does
    (5.7e-7 against the twin's 5.2e-7 here); one chain along the whole k
    axis (N = 1024 long) lands 3× as far (1.7e-6). Both stay inside
    K9_TOL, whose atol is 5e-5: under this model the tolerance cannot see
    the fault, so the test holds the distance from fp64. D = 28 keeps the
    emulation to seconds; the chain's length is N."""
    x, s, h = _inputs(rng, 1024, 28, 100.0)
    ref = kv.rbf_velocity_plain(torch.from_numpy(x).double(), torch.from_numpy(s).double(),
                                torch.tensor(h, dtype=torch.float64)).numpy()
    twin = np.abs(_twin(x, s, h) - ref).max()
    plan = kv.velocity_plan(1024, 28)
    err = {}
    for flush in (2, None):
        got = emulated_k9(x, s, h, plan, lambda a, b: mm_3xtf32_truncating(a, b, flush))
        np.testing.assert_allclose(got, ref, **K9_TOL)
        err[flush] = np.abs(got - ref).max()
    assert err[2] <= 1.5 * twin < err[None] / 2, (twin, err)
