"""The port's sharded solvers on a gloo group of 2 CPU ranks against the JAX
package's sharded functions on a 2-device CPU mesh, from the same inputs:
the DuSt solve in the gather ``gram_mode`` (the pendulum at λ=2 of
``tests/test_parallel_dust.py``, 2e-3 / 2e-4), ``sharded_svgd_run`` with
the RBF kernel and with ``sharded_pathsig_score`` (``tests/test_parallel.py``'s
shapes, 1e-3 / 1e-4, also against the port's single-device ``SVGD.run``)
and ``sharded_mpf_observe`` with a fixed and a Silverman bandwidth
(``tests/test_parallel_mpf.py``: 1e-4 / 1e-5, norms atol 1e-6, also against
``MPF.observe``).
"""
import numpy as np
import pytest

from _jax_parallel_refs import (
    SVGD_STEPS, check_dust, dust_case, jax_dust, jax_mpf, jax_svgd, mpf_case, svgd_case,
)
from _torch_dist_ranks import result, start_ranks

SVGD = ("svgd_rbf", "svgd_pathsig")
BWS = (0.3, None)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cases = [dust_case("gather")] + [svgd_case(n) for n in SVGD] + [mpf_case(bw) for bw in BWS]
    ranks = start_ranks(2, cases, tmp_path_factory.mktemp("jax_gather"))
    try:
        want = {"gather": jax_dust("gather")}
        want.update({n: jax_svgd(n) for n in SVGD})
        want.update({f"mpf_{bw}": jax_mpf(bw) for bw in BWS})
    finally:
        port = ranks.join()
    return port, want


def test_sharded_gather_dust_matches_jax_sharded(both):
    port, want = both
    check_dust(result(port, "gather"), "gather", want["gather"])


@pytest.mark.parametrize("name", SVGD)
def test_sharded_svgd_run_matches_jax_sharded(both, name):
    port, want = both
    out = result(port, name)
    np.testing.assert_allclose(out["x"], want[name], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out["x"], out["single"], rtol=1e-3, atol=1e-4)
    assert out["losses"].shape == (SVGD_STEPS[name],)


@pytest.mark.parametrize("bw", BWS)
def test_sharded_mpf_matches_jax_sharded_and_single_device(both, bw):
    port, want = both
    out = result(port, f"mpf_{bw}")
    particles, grads, prior_bw = want[f"mpf_{bw}"]
    for ref in (particles, out["single"]["particles"]):
        np.testing.assert_allclose(out["particles"], ref, rtol=1e-4, atol=1e-5)
    for ref in (grads, out["single"]["grads"]):
        np.testing.assert_allclose(out["grads"], ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["prior_bw"], prior_bw, rtol=1e-6)
    np.testing.assert_array_equal(out["prior_means"], out["particles"])
