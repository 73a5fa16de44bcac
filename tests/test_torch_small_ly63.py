"""K7's plain twins against the JAX package's ``pallas_pair_gram_small``
(interpret mode) at the widest grid the λ=0 pair list takes, ly1 = 63: 2048
random pairs of [3, 4, 2] × [4, 64, 2] paths, k to rtol 3e-5 / atol 2e-5
and the gradients with respect to X, Y and the bandwidth, scaled by their
max, to atol 5e-5 (``tests/test_pallas_small.py``). A file of its own: the
JAX kernel's interpret mode takes minutes to compile at this width, and the
test workers take files in parallel.
"""
from test_torch_small import k7_against_jax


def test_k7_twin_matches_jax_at_ly1_63(rng):
    k7_against_jax(rng, ((3, 4, 2), (4, 64, 2)))
