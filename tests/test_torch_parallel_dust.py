"""The port's sharded DuSt solve on a gloo group of 2 CPU ranks against its
single-device ``DuSt.forward``, at ``tests/test_parallel_dust.py``'s
pendulum shapes and tolerances (policy mode 1e-3 / 1e-4, signature and
trajectory modes 2e-3 / 2e-4, the Gram modes against each other 1e-4 /
1e-5): every gram mode, both tile-subset paths (K1's twin at λ=0 and K2's
at λ=3), the median bandwidths, Monte-Carlo and parameter samples with the
generator's draws, the three rolls, the weighted prior over two chained
solves, frozen primitives, ``roll_opt_state``, the closed loop of
``make_sharded_mpc_step``, the collective inventory within the JAX
package's budgets (``tests/test_parallel_scaling.py``) and the scaling
curve's harness. The ranks run in ``tests/_torch_dist_ranks.py`` (no JAX);
all cases in one spawn.
"""
import numpy as np
import pytest

from _torch_dist_ranks import result, start_ranks

STATE = [float(np.pi), 0.0]


def _pol(n, hz, seed):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, hz, 1)).astype(np.float32)


POLICY = dict(hz_len=10, n_pol=16, kernel_mode="policy", adam=0.1)
SIG = dict(hz_len=8, n_pol=16, kernel_mode="signature", adam=0.1,
           sig=dict(dyadic_order=2, bandwidth=2.0))

CASES = {
    "policy": dict(ctrl=POLICY, opt_steps=2, tol=(1e-3, 1e-4)),
    "sig_modes": dict(ctrl=SIG, opt_steps=2, modes=["gather", "ring", "triangle"],
                      tol=(2e-3, 2e-4)),
    "sig_median": dict(ctrl=dict(SIG, sig=dict(dyadic_order=2)), opt_steps=2,
                       modes=["gather", "ring", "triangle"], tol=(2e-3, 2e-4)),
    "lambda0_tiles": dict(ctrl=dict(hz_len=12, n_pol=48, kernel_mode="signature", lr=0.05,
                                    sig=dict(dyadic_order=0, bandwidth=4.0)),
                          opt_steps=1, modes=["triangle"], tol=(2e-3, 2e-4)),
    "lambda3_tiles": dict(ctrl=dict(hz_len=8, n_pol=32, kernel_mode="signature", lr=0.05,
                                    sig=dict(dyadic_order=3, bandwidth=4.0, solver="pallas")),
                          opt_steps=1, modes=["triangle"], tol=(2e-3, 2e-4)),
    "trajectory_fixed": dict(ctrl=dict(hz_len=8, n_pol=16, kernel_mode="trajectory",
                                       adam=0.1, kernel_bw=2.0), opt_steps=2,
                             tol=(2e-3, 2e-4)),
    "trajectory_median": dict(ctrl=dict(hz_len=8, n_pol=16, kernel_mode="trajectory",
                                        lr=0.05), opt_steps=2, tol=(2e-3, 2e-4)),
    "mc_params": dict(ctrl=dict(SIG, n_action_samples=3, n_params_samples=2), opt_steps=2,
                      params_dist=([9.8, 1.0, 1.0], [0.25, 0.01, 0.01]), seed=4, tol=(2e-3, 2e-4)),
    "roll_mean": dict(ctrl=dict(POLICY, roll_strategy="mean"), opt_steps=2,
                      tol=(1e-3, 1e-4)),
    "roll_resample": dict(ctrl=dict(POLICY, roll_strategy="resample"), opt_steps=2, seed=3,
                          tol=(1e-3, 1e-4)),
    "weighted_prior": dict(ctrl=dict(POLICY, weighted_prior=True), opt_steps=2, solves=2,
                           tol=(1e-3, 1e-4)),
    "roll_opt_state": dict(ctrl=dict(POLICY, roll_opt_state=True), opt_steps=2,
                           tol=(1e-3, 1e-4)),
    "primitives": dict(ctrl=dict(POLICY, n_pol=12, n_prim=4), opt_steps=2,
                       prims=np.repeat(np.linspace(-1.0, 1.0, 4, dtype=np.float32)[:, None, None],
                                       10, axis=1), tol=(1e-3, 1e-4)),
}


def _spec(name, c):
    ctrl = c["ctrl"]
    spec = {k: v for k, v in c.items() if k != "tol"}
    spec.update(state=STATE, pol0=_pol(ctrl["n_pol"], ctrl["hz_len"], 7))
    return (name, "case_dust", spec)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [_spec(n, c) for n, c in CASES.items()]
    cases += [
        ("closed_loop", "case_closed_loop",
         dict(ctrl=POLICY, opt_steps=2, steps=3, state=STATE, pol0=_pol(16, 10, 1))),
        ("inventory_policy", "case_inventory",
         dict(ctrl=POLICY, state=STATE, pol0=_pol(16, 10, 0))),
        ("inventory_signature", "case_inventory",
         dict(ctrl=dict(SIG, hz_len=10), state=STATE, pol0=_pol(16, 10, 0))),
        ("scaling", "case_scaling", dict(ctrl=dict(POLICY, n_pol=32), state=STATE,
                                         pol0=_pol(32, 10, 0))),
        ("global", "case_global", dict(seed=3, shape=(8, 3))),
    ]
    return start_ranks(2, cases, tmp_path_factory.mktemp("dust_ranks")).join()


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1], err_msg=msg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_solve_matches_single_device(ranks, name):
    """The actions, the rolled policies, the prior weights and Adam's
    moments of every solve (two chained with the weighted prior) against
    the single-device solve; the Gram modes against each other."""
    out = result(ranks, name)
    tol = CASES[name]["tol"]
    modes = [m for m in out if m not in ("single", "launches")]
    for mode in modes:
        for i, (got, want) in enumerate(zip(out[mode], out["single"])):
            assert len(got) == len(want)
            for k, (g, w) in enumerate(zip(got, want)):
                _close(g, w, tol, f"{name} {mode} solve {i} leaf {k}")
    for mode in modes[1:]:
        _close(out[mode][0][0], out[modes[0]][0][0], (1e-4, 1e-5), f"{name} {mode}")
        _close(out[mode][0][1], out[modes[0]][0][1], (1e-4, 1e-5), f"{name} {mode}")
    if name == "weighted_prior":
        assert np.asarray(out[modes[0]][0][2]).std() > 1e-6  # the weights are not uniform
    if name == "primitives":
        rolled = np.roll(CASES[name]["prims"], -1, axis=-2)
        rolled[..., -1, :] = rolled[..., -2, :]
        np.testing.assert_allclose(out[modes[0]][0][1][:4], rolled, atol=1e-6)
    if name == "roll_opt_state":
        for leaf in out[modes[0]][0][3:]:
            if leaf.ndim == 3:
                np.testing.assert_allclose(leaf[..., -1, :], 0.0)


def test_sharded_closed_loop_matches_single_device(ranks):
    out = result(ranks, "closed_loop")
    assert np.isfinite(out["states"]).all() and np.isfinite(out["pol"]).all()
    assert out["step"] == 6
    _close(out["states"], out["single"], (1e-3, 1e-4))


@pytest.mark.parametrize("mode", ["policy", "signature"])
def test_collective_inventory_within_jax_budget(ranks, mode):
    """Policy mode: at most 5 gathers (the prior once, then per step the
    scores and the particles), at most 2·45 + 10 all-reduces (the median's
    bisection dominates), under 2 MB; signature mode (triangle, fixed
    bandwidth): at most 5 gathers and 12 all-reduces."""
    stats = result(ranks, f"inventory_{mode}")
    ag = stats.get("all-gather", {"count": 0, "bytes": 0})
    ar = stats.get("all-reduce", {"count": 0, "bytes": 0})
    assert 1 <= ag["count"] <= 5, stats
    if mode == "policy":
        assert ar["count"] <= 2 * 45 + 10, stats
        assert (ag["bytes"] + ar["bytes"]) / 1e6 < 2.0, stats
    else:
        assert ar["count"] <= 12, stats
    assert "collective-permute" not in stats


def test_scaling_curve_runs(ranks):
    rows = result(ranks, "scaling")
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(r["solves_per_s"]) and r["solves_per_s"] > 0


def test_global_particles_are_each_ranks_rows_of_one_draw(ranks):
    import torch

    out = result(ranks, "global")
    assert out["rank"] == 0 and out["mesh"] == ["dp", "sp"] and out["shape"] == [2, 1]
    want = torch.randn((8, 3), generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(out["rows"], want)


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the CPU-only raise")
def test_make_mesh_needs_a_card_unless_given_cpu():
    """``device_type=None`` means the card: without one ``make_mesh``
    raises; on the CPU it needs a process group."""
    from sigsvgd_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")
