"""The port's policy-mode pieces against the JAX package: the Gaussian
kernel (with ``analytic_grad`` either way), the fused RBF Stein velocity's
plain twin (K9's CPU path) and K9's envelope, the DuSt and SVGD defaults
and fields, and two chained policy-mode MPC solves.

Tolerances: ``GaussianKernel`` K rtol 1e-5 and dK rtol 1e-4, atol 1e-5
(``tests/test_kernels.py``); the velocity rtol 2e-4, atol 5e-5
(``tests/test_pallas_svgd.py``); the chained solves as
``tests/test_torch_dust.py`` states them.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.controllers import DuSt as JDuSt
from sigsvgd_tpu.inference import SVGD as JSVGD
from sigsvgd_tpu.kernels import GaussianKernel as JGaussianKernel
from sigsvgd_tpu.kernels.pallas_svgd import fused_rbf_velocity_pallas, xla_rbf_velocity
from sigsvgd_tpu_torch.controllers.dust import DuSt
from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
from sigsvgd_tpu_torch.inference.svgd import SVGD, ScaledSVGD
from sigsvgd_tpu_torch.kernels import svgd_velocity as kv
from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
from test_torch_dust import run_two_chained_solves


@pytest.mark.parametrize("h", [1.3, None])
def test_gaussian_kernel_matches_jax(rng, h):
    X = rng.standard_normal((9, 5)).astype(np.float32)
    Y = rng.standard_normal((7, 5)).astype(np.float32)
    for xa, ya in ((X, X), (X, Y)):
        K, dK = GaussianKernel()(torch.from_numpy(xa), torch.from_numpy(ya), h=h)
        Kj, dKj = JGaussianKernel()(jnp.asarray(xa), jnp.asarray(ya), h=h)
        np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5)
        np.testing.assert_allclose(dK.numpy(), np.asarray(dKj), rtol=1e-4, atol=1e-5)
    # [n, H, a] particles flatten as the JAX kernel flattens them
    P = rng.standard_normal((6, 4, 3)).astype(np.float32)
    K, dK = GaussianKernel(bw_scale=0.7)(torch.from_numpy(P), torch.from_numpy(P))
    Kj, dKj = JGaussianKernel(bw_scale=0.7)(jnp.asarray(P), jnp.asarray(P))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5)
    np.testing.assert_allclose(dK.numpy(), np.asarray(dKj), rtol=1e-4, atol=1e-5)
    assert not GaussianKernel()(torch.from_numpy(X), torch.from_numpy(X),
                                compute_grad=False).requires_grad


@pytest.mark.parametrize("n,d", [(100, 17), (64, 128), (257, 7), (40, 280)])
def test_velocity_twin_matches_jax_xla_and_pallas(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = rng.standard_normal((n, d)).astype(np.float32)
    h = 1.3 if d < 100 else float(np.sqrt(d))
    got = kv.fused_rbf_velocity(torch.from_numpy(x), torch.from_numpy(s),
                                torch.tensor(h))  # CPU: the twin
    ref = xla_rbf_velocity(jnp.asarray(x), jnp.asarray(s), jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=5e-5)
    pal = fused_rbf_velocity_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(h),
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=2e-4, atol=5e-5)


def test_velocity_bound_counts_and_envelope():
    """K9 takes every D the JAX kernel takes: it streams D in k-slices at
    any width (a 7-DoF policy at H ≥ 115 has D > 800); only arrays that do
    not index in 32 bits stay outside."""
    assert kv.velocity_flops(1024, 280) == 3 * 2 * 1024 ** 2 * 280
    assert kv.velocity_bytes(1024, 280) == 4.0 * 3 * 1024 * 280
    assert kv.velocity_supported(1024, 280) and kv.velocity_supported(1, 800)
    assert kv.velocity_supported(1024, 801) and kv.velocity_supported(1024, 7 * 200)
    assert not kv.velocity_supported(1 << 20, 4096)
    assert not kv.velocity_supported(0, 280)


def test_unported_kernel_gradient_option_raises(rng):
    """``analytic_grad`` is accepted and not read, as in the JAX package:
    both values give the same (K, dK), held against JAX's at the
    ``GaussianKernel`` tolerances."""
    X = rng.standard_normal((9, 5)).astype(np.float32)
    Y = rng.standard_normal((7, 5)).astype(np.float32)
    Kj, dKj = JGaussianKernel(analytic_grad=False)(jnp.asarray(X), jnp.asarray(Y))
    K, dK = GaussianKernel()(torch.from_numpy(X), torch.from_numpy(Y))
    K2, dK2 = GaussianKernel(analytic_grad=False)(torch.from_numpy(X), torch.from_numpy(Y))
    torch.testing.assert_close(K2, K, rtol=0, atol=0)
    torch.testing.assert_close(dK2, dK, rtol=0, atol=0)
    np.testing.assert_allclose(K2.numpy(), np.asarray(Kj), rtol=1e-5)
    np.testing.assert_allclose(dK2.numpy(), np.asarray(dKj), rtol=1e-4, atol=1e-5)


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


def _assert_same_defaults(port_cls, ref_cls, path=""):
    """Equal defaults for every field the two dataclasses share;
    dataclass-valued defaults are compared field by field the same way."""
    port, ref = _defaults(port_cls), _defaults(ref_cls)
    shared = sorted(set(port) & set(ref))
    assert shared
    for name in shared:
        a, b = port[name], ref[name]
        if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
            assert type(a).__name__ == type(b).__name__, path + name
            _assert_same_defaults(type(a), type(b), f"{path}{name}.")
            for sub in set(_defaults(type(a))) & set(_defaults(type(b))):
                assert getattr(a, sub) == getattr(b, sub), f"{path}{name}.{sub}"
        else:
            assert a == b, path + name


def test_dust_and_svgd_defaults_match_jax():
    _assert_same_defaults(DuSt, JDuSt)
    _assert_same_defaults(SVGD, JSVGD)
    assert _defaults(DuSt)["kernel_mode"] == "policy"


def test_dust_fields_take_the_jax_defaults_and_name_their_item_otherwise():
    """Every field of the JAX ``DuSt`` exists in the port's. The options
    the port has ported are accepted at values other than their defaults;
    the trajectory mode and the scaled samplers, ported since, each run a
    solve (``tests/test_torch_dust_trajectory.py`` holds them against JAX);
    ``init_uniform_range`` bounds the initial draws, as in the JAX
    package."""
    port = {f.name for f in dataclasses.fields(DuSt)}
    assert {f.name for f in dataclasses.fields(JDuSt)} <= port
    prob = build_arm_mpc(device="cpu", n_pol=4, hz_len=4, kernel_mode="policy")
    ctrl = prob.ctrl
    for name, value in (("pol_cov", ((2.0,) * 7,) * 7), ("params_log_space", True),
                        ("weighted_prior", True), ("roll_opt_state", True),
                        ("n_prim", 2), ("n_action_samples", 10),
                        ("n_params_samples", 3), ("roll_strategy", "resample"),
                        ("roll_strategy", "mean")):
        assert getattr(dataclasses.replace(ctrl, **{name: value}), name) == value
    for name, value in (("kernel_mode", "trajectory"), ("stein_sampler", "ScaledSVGD")):
        other = dataclasses.replace(ctrl, **{name: value})
        cs = other.init(generator=torch.Generator().manual_seed(0))
        a, cs2, _ = other.forward(prob.q_start, cs, opt_steps=1)
        assert a.shape == (4, 7) and torch.isfinite(cs2.pol_mean).all()
    assert isinstance(dataclasses.replace(ctrl, stein_sampler="ScaledSVGD")._sampler(),
                      ScaledSVGD)
    narrow = dataclasses.replace(ctrl, init_uniform_range=0.25)
    pol = narrow.init(generator=torch.Generator().manual_seed(0)).pol_mean
    assert pol.abs().max() <= 0.25 and pol.abs().max() > 0.2


@pytest.mark.parametrize("mode_name", ["policy", "policy_fused"])
def test_two_chained_policy_solves_match_jax(mode_name):
    run_two_chained_solves(mode_name)
