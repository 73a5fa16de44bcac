"""The port's sharded DuSt solve on a gloo group of 2 CPU ranks against the
JAX package's sharded solve on a 2-device CPU mesh, from the same policies,
in the ring and triangle ``gram_mode``s (the pendulum at λ=2 of
``tests/test_parallel_dust.py``, 2e-3 / 2e-4; the gather mode is in
``tests/test_torch_parallel_gather.py``). The port's ranks run in
``tests/_torch_dist_ranks.py`` while JAX computes here
(``tests/_jax_parallel_refs.py``).
"""
import pytest

from _jax_parallel_refs import check_dust, dust_case, jax_dust
from _torch_dist_ranks import result, start_ranks

MODES = ("ring", "triangle")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ranks = start_ranks(2, [dust_case(m) for m in MODES],
                        tmp_path_factory.mktemp("jax_modes"))
    try:
        want = {m: jax_dust(m) for m in MODES}
    finally:
        port = ranks.join()
    return port, want


@pytest.mark.parametrize("mode", MODES)
def test_sharded_dust_matches_jax_sharded(both, mode):
    port, want = both
    check_dust(result(port, mode), mode, want[mode])
