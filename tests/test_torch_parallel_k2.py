"""The port's λ=3 tile-subset path on a gloo group of 2 CPU ranks against the
JAX package's sharded solve on a 2-device CPU mesh: each rank runs K2's twin
over every other tile of K2's list, against JAX's ``pallas`` block3 tiles
(the pendulum, H=8, 32 policies, ``tests/test_parallel_dust.py``, 2e-3 /
2e-4).
"""
import pytest

from _jax_parallel_refs import check_dust, dust_case, jax_dust
from _torch_dist_ranks import result, start_ranks


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ranks = start_ranks(2, [dust_case("lambda3_tiles")], tmp_path_factory.mktemp("jax_k2"))
    try:
        want = jax_dust("lambda3_tiles")
    finally:
        port = ranks.join()
    return port, want


def test_sharded_lambda3_tiles_match_jax_sharded(both):
    port, want = both
    check_dust(result(port, "lambda3_tiles"), "lambda3_tiles", want)
