"""The tile-subset paths and the 2-D pair grid of the port's sharded
solvers.

* On a gloo group of 2 CPU ranks: the λ=0 sharded triangle solve, whose
  ranks each run K1's twin over every other tile of K1's tile list, against
  the JAX package's ``pallas_small`` block-tile solve on a 2-device mesh
  (pendulum, H=12, 48 policies, 2e-3 / 2e-4, ``tests/test_parallel_dust.py``)
  and ``distributed_median`` exact (atol 0) with its differentiable
  variant's gradient on one element equal to it.
* On 4 ranks as a ``[2, 2]`` ``("dp", "sp")`` mesh, ``col_axis="sp"``,
  against the port's single-device functions: the RBF and path-signature
  SVGD runs (``tests/test_parallel.py``, 1e-3 / 1e-4), the signature DuSt
  solve on the 2-D pair grid (2e-3 / 2e-4) and the median over both axes.
* Here, without ranks: K1's and K2's subset twins summed over 2 and 3
  ranks equal the whole twins; ``tile_shard`` deals JAX's own tile list as
  ``block_tile_shard`` does, and ``_triangle_groups`` with the triangle
  blocks equal JAX's rule, bit for bit.
"""
import numpy as np
import pytest
import torch

from _jax_parallel_refs import STATE, check_dust, dust_case, jax_dust
from _torch_dist_ranks import result, start_ranks
from sigsvgd_tpu.kernels import pallas_sigkernel_block as jblock
from sigsvgd_tpu.parallel.dust import _triangle_groups as j_triangle_groups
from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
from sigsvgd_tpu_torch.kernels import sigkernel_block3 as k3
from sigsvgd_tpu_torch.parallel.dust import _triangle_groups, triangle_blocks

VALS = np.random.default_rng(9).standard_normal((8, 24)).astype(np.float32)
X2D = {"pathsig": (np.random.default_rng(2).standard_normal((16, 4, 2)) * 0.5).astype(np.float32),
       "rbf": (np.random.default_rng(3).standard_normal((32, 3)) + 1.0).astype(np.float32)}
MESH2 = dict(mesh=[2, 2], axes=("dp", "sp"))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    two = start_ranks(2, [dust_case("lambda0_tiles"),
                          ("median", "case_median", dict(vals=VALS))],
                      tmp_path_factory.mktemp("k1_two"))
    pol = np.random.default_rng(5).uniform(-2.0, 2.0, (16, 8, 1)).astype(np.float32)
    four = start_ranks(4, [
        ("pathsig_2d", "case_svgd", dict(MESH2, score="pathsig", x0=X2D["pathsig"], steps=10,
                                         col_axis="sp")),
        ("rbf_2d", "case_svgd", dict(MESH2, score="rbf", adam=True, x0=X2D["rbf"], steps=20,
                                     col_axis="sp")),
        ("dust_2d", "case_dust", dict(MESH2, ctrl=dict(hz_len=8, n_pol=16,
                                                       kernel_mode="signature", adam=0.1,
                                                       sig=dict(dyadic_order=2, bandwidth=2.0)),
                                      opt_steps=2, modes=["gather"], col_axis="sp",
                                      state=STATE, pol0=pol)),
        ("median_2d", "case_median", dict(MESH2, vals=VALS)),
    ], tmp_path_factory.mktemp("k1_four"))
    try:
        want = jax_dust("lambda0_tiles")
    finally:
        port = two.join()
        port.update(four.join())
    return port, want


def test_sharded_lambda0_tiles_match_jax_sharded(both):
    port, want = both
    check_dust(result(port, "lambda0_tiles"), "lambda0_tiles", want)


@pytest.mark.parametrize("name", ["median", "median_2d"])
def test_distributed_median_is_exact(both, name):
    """The value equals the lower middle order statistic exactly. Every
    rank differentiates its own 3·median and the sum over the ranks carries
    their cotangents, so the gradient, 3 per rank, lies on one element: the
    one equal to the median."""
    out = result(both[0], name)
    flat = VALS.reshape(-1)
    k = (flat.size - 1) // 2
    want = np.partition(flat, k)[k]
    np.testing.assert_allclose(out["median"], want, rtol=0, atol=0)
    np.testing.assert_allclose(out["median_diff"], want, rtol=0, atol=0)
    hits = [(r, g) for r, g in out["grads"] if np.any(g != 0)]
    assert len(hits) == 1
    world = 2 if name == "median" else 4
    r, g = hits[0]
    assert np.count_nonzero(g) == 1 and g.sum() == 3.0 * world
    assert len(out["grads"]) == world


@pytest.mark.parametrize("name", ["pathsig_2d", "rbf_2d"])
def test_sharded_svgd_on_the_2d_pair_grid_matches_single_device(both, name):
    out = result(both[0], name)
    np.testing.assert_allclose(out["x"], out["single"], rtol=1e-3, atol=1e-4)


def test_sharded_dust_on_the_2d_pair_grid_matches_single_device(both):
    out = result(both[0], "dust_2d")
    for g, w in zip(out["gather"][0], out["single"][0]):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("ndev", [2, 3])
def test_subset_twins_sum_to_the_whole_twin(kernel, ndev):
    """Over ranks' tile subsets, K (each pair once) and dX of the twins sum
    to the whole twin's, and the ``K@s`` partials to ``K@s``."""
    rng = np.random.default_rng(4)
    X = torch.from_numpy((rng.standard_normal((37, 9, 2)) * 0.3).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((37, 5)).astype(np.float32))
    whole = (kb.block_gram_and_grad if kernel == "k1" else k3.block3_gram_and_grad)
    part = kb.block_tiles_ks_partial if kernel == "k1" else k3.block3_tiles_ks_partial
    K, dX = whole(X, 2.0)
    parts = [(whole(X, 2.0, shard=(ndev, r)), part(X, 2.0, s, ndev, r)) for r in range(ndev)]
    np.testing.assert_allclose(sum(p[0][0] for p in parts).numpy(), K.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sum(p[0][1] for p in parts).numpy(), dX.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(p[1][0] for p in parts).numpy(), (K @ s).numpy(),
                               rtol=1e-5, atol=1e-5)
    # every pair a ≤ b in exactly one rank's tiles
    tc = kb.THREADS // kb.block_lanes(9)[0]
    tiles = kb._tile_list(37, tc, "cpu")
    got = sorted(p for r in range(ndev)
                 for p in zip(*(t.tolist() for t in kb.tile_pairs(kb.tile_shard(tiles, ndev, r),
                                                                  37, tc))))
    assert got == sorted(zip(*(t.tolist() for t in torch.triu_indices(37, 37))))


@pytest.mark.parametrize("n,ndev", [(1024, 2), (1024, 8), (300, 3), (128, 4)])
def test_tile_shard_deals_as_jax(n, ndev):
    """``tile_shard`` on JAX's own tile list gives each device JAX's
    ``block_tile_shard`` tiles (its zero-weight padding aside)."""
    n_pad = -(-n // 128) * 128
    I, J, _ = jblock._tile_lists(n_pad)
    tiles = torch.from_numpy(np.stack([np.asarray(I), np.asarray(J)], 1).astype(np.int32))
    tI, tJ, _, tW = jblock.block_tile_shard(n, ndev)
    for r in range(ndev):
        keep = tW[r] > 0
        want = np.stack([tI[r][keep], tJ[r][keep]], 1)
        np.testing.assert_array_equal(kb.tile_shard(tiles, ndev, r).numpy(), want)


def test_triangle_groups_and_blocks_match_jax():
    for n in (16, 24, 48, 64, 128, 384, 1000, 1024, 4096):
        for ndev in (1, 2, 3, 4, 8):
            if n % ndev:
                continue
            g = _triangle_groups(n, ndev)
            assert g == j_triangle_groups(n, ndev), (n, ndev)
            blocks = [(a, b) for a in range(g) for b in range(a, g)]
            dealt = [blk for r in range(ndev) for blk in triangle_blocks(n, ndev, r)]
            assert sorted(dealt) == blocks
            for r in range(ndev):
                assert triangle_blocks(n, ndev, r) == [blocks[i] for i in range(r, len(blocks),
                                                                                 ndev)]
    assert _triangle_groups(1024, 2) == 16 and _triangle_groups(16, 4) == 8
