"""The port's kernels on the card, each held against its plain twin:

* K1 (λ=0 Gram + adjoint; a lane group per pair): K bit for bit (within
  ``tests/test_pallas_block.py``'s atol 3e-5), dX scaled by max|dX| atol
  5e-5, its tolerance, at every instantiation (C = 1..3 up to L = 64, C =
  4..8 up to L·C = 128); dX bit for bit across two calls;
* K2 (λ=3 Gram + adjoint): K atol 1e-4, dX scaled atol 4e-4 (against the
  twin in fp64), those of ``tests/test_pallas_block3.py``, at every
  instantiation as K1; both raise just past their envelope, and
  ``gram_and_grad`` takes them on the planner's [1024, 3, 7] knots (λ=0 and
  λ=3) and the pair lists (K7, K4) beyond L·C = 128;
* K9 (fused RBF Stein velocity): rtol 2e-4, atol 5e-5, those of
  ``tests/test_pallas_svgd.py``, with scores of unit size and 100 times
  larger, over row and column chunks of K; φ bit for bit across calls;
* K8 (the order ≥ 6 hop chain, forward and backward): K and dz scaled by
  their max, atol 1e-3 and 2e-3 (twin and kernel round to bf16 in the same
  places, but a hop input that differs in its last fp32 bit can round to
  another bf16), at the plan's corners (one and two warpgroups a block,
  ragged tiles, more tiles than blocks, 1 to 64 hops, sub = 2); k and dz bit
  for bit across two calls;
* K4 (the λ=3 pair-list forward and fp32 backward): K atol 1e-4, both
  tiles' gradients scaled atol 4e-4 against the twin in fp64, K2's;
* K4's forward on its lane schedule: k, ck and rc bit for bit against the
  twin and across calls, at 1, 8 and 16 lanes a pair and over several
  tiles a block; its backward on its lane schedule at the same tolerance
  over three passes of its persistent loop and at ly1 = 48 with C = 8
  (16 lanes of at most 3 coarse columns), dx and dy bit for bit across
  calls;
* K6 (the bf16 delta-form backward, C ≤ 4, ly1 ≤ 40): against its bf16 twin
  rel ≤ 2e-2 and cos ≥ 0.999 (the bf16 chains see inputs that differ from
  the twin's in their last fp32 bit); against K4's fp32 backward rel <
  0.25, cos > 0.98; dx, dy bit for bit across calls;
* K7 (the λ=0 pair-list forward and backward; a lane group per pair): k
  and fac atol 3e-5, both tiles' gradients scaled by their max atol 5e-5,
  those of ``tests/test_pallas_small.py``, at C = 1..8, over three passes
  of each launch's persistent loop, at one row and one column of cells;
  k, fac, dx and dy bit for bit across calls;
* K3 (the λ=0 values-only block Gram; one thread a pair, bands swept as a
  wavefront): K the twin's bit for bit at every instantiation's shapes
  (C = 1..8, L·C ≤ 128, more tiles than resident blocks) and K1's (all
  three round as the twin does); K bit for bit across calls;
* K5 (the λ=3 solve on given increments, forward and stable backward): k
  rtol 2e-5 / atol 1e-6 and dz scaled by max|dz| atol 5e-4 against the fp32
  twin, those of ``tests/test_pallas_sigkernel.py`` (at its MPC shape 1e-4
  and 1e-3), the checkpoints (in the twin's layout, ``twin_checkpoints``)
  at the forward's tolerance, at 1, 2, 4, 8 and 16 lanes a pair, and the
  routes that launch it (the dense λ=3 ``gram``, linear statics, C > 8).

And the score-function DuSt solve (10 action samples' kind, here 4 on 16
policies, H = 8) on the card against the same solve on the CPU with the
same given draws: K1 launched twice, the first step's costs rtol 1e-5, K
atol 3e-5 and the repulsion scaled 5e-5 (``tests/test_torch_dust.py``'s
λ=0 mode), φ scaled 1e-4, the weights' argmax. The wavefront (torch ops)
on the card against the CPU, and the trajectory-mode and MatrixSVGD first
steps likewise. K2 at the particle maze's [35, 30, 2] and [36, 30, 2] on
the maze's own τ, and a 3-step maze episode (signature kernel, MPF on) on
the card against the CPU with the same draws. L-BFGS with the zoom line
search one update at a time on the card against the CPU (every state leaf
within rtol 1e-5 / atol 1e-6, the probe counts equal); checkpoints of card
tensors and of a CUDA generator's state; a mesh obstacle's grid lookup
(values and gradients within 1e-6) and the toy targets on the card against
the CPU; the MoveIt importer and a gymnasium swing-up with the controller on
the card, which skip where PyYAML or gymnasium is missing.

These tests need a CUDA card and skip without one. The file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import mxu_chain as mc
from sigsvgd_tpu_torch.kernels import sigkernel as sk
from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf
from sigsvgd_tpu_torch.kernels import sigkernel_small as ks
from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt
from sigsvgd_tpu_torch.kernels import svgd_velocity as kv
from sigsvgd_tpu_torch.kernels.sigkernel import (
    SignatureKernel, _pair_sq_dists, gram_increments,
)
from sigsvgd_tpu_torch.utils.math import bw_median, pw_dist_sq


def _assert_k_dx(K, dX, Kp, dXp, k_atol=3e-5, dx_atol=5e-5):
    torch.testing.assert_close(K, Kp, atol=k_atol, rtol=0)
    scale = dXp.abs().max()
    torch.testing.assert_close(dX / scale, dXp / scale, atol=dx_atol, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA kernels "
                    "with no CPU mode")
    return torch.device("cuda")


def _paths(device, n, L, C, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.cumsum((torch.rand((n, L, C), generator=g, device=device) - 0.5) * 0.2,
                        dim=1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 40, 2), (333, 40, 2), (33, 21, 3), (7, 5, 3),
                                   (40, 64, 3), (5, 2, 1), (2, 2, 3), (19, 30, 1),
                                   (130, 45, 2),
                                   # C = 4..8 (span template 3): the planner's
                                   # knots, each C at L·C = 128, ragged n, n = 2
                                   (1024, 3, 7), (1024, 16, 8), (1024, 32, 4),
                                   (333, 18, 7), (50, 25, 5), (64, 21, 6), (2, 2, 8),
                                   (77, 9, 4)])
def test_k1_matches_plain_twin_on_the_card(cuda_device, n, L, C):
    """1, 2, 4, 8 and 16 lanes a pair (L = 2 and 5, 21, 30 and 40, 45 and
    64; at C > 3: 1 at L = 3, 4 at 9, 8 at 16 and 18, 16 at 21-32), ragged
    n, one pair (n = 2), and at n = 1024 more tiles than resident blocks.
    K is the twin's bit for bit: the statics and the forward sweep round as
    the twin does, whatever the lanes and channels."""
    X = _paths(cuda_device, n, L, C)
    before = kb.block_gram_and_grad.launches
    K, dX = kb.block_gram_and_grad(X, 4.0)
    assert kb.block_gram_and_grad.launches == before + 1
    Kp, dXp = kb.block_gram_and_grad_plain(X, 4.0)
    assert torch.equal(K, Kp)
    _assert_k_dx(K.cpu(), dX.cpu(), Kp.cpu(), dXp.cpu())
    if n == 1024:
        tiles, blocks = kb.block_grid(n, L, C, cuda_device)
        assert tiles.shape[0] > blocks


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 40, 2), (77, 64, 3), (1024, 3, 7), (333, 16, 8)])
def test_k1_is_bitwise_repeatable(cuda_device, n, L, C):
    """No atomics: the gradient sums run in a fixed order."""
    X = _paths(cuda_device, n, L, C, seed=1)
    K1, dX1 = kb.block_gram_and_grad(X, 4.0)
    K2, dX2 = kb.block_gram_and_grad(X, 4.0)
    assert torch.equal(K1, K2) and torch.equal(dX1, dX2)


@pytest.mark.cuda
def test_k1_raises_outside_its_envelope(cuda_device):
    """K1's wrapper raises outside its envelope; ``SignatureKernel`` sends
    order 2 and order 3 beyond ly1 = 48 (outside K2) to the wavefront. Its
    fp32 result on the card and on the CPU is each held against the fp64
    CPU result at the fp32 route's own distance from it: K rtol 1e-3 (the
    λ=3 fp32 K is 5.6e-4 to 7.8e-4 from fp64 on flagship-like paths, the
    static Gram's double differences cancelling; 6.5e-4 here on the CPU)
    and dX scaled 3e-3 (1.1e-3 on the CPU at order 3 on 65 nodes); the two
    devices' exp round apart, so they differ by as much."""
    with pytest.raises(NotImplementedError, match="K7"):
        kb.block_gram_and_grad(torch.zeros(8, 65, 2, device=cuda_device), 4.0)
    for order, L in ((2, 40), (3, 65)):
        kern = SignatureKernel(dyadic_order=order, bandwidth=4.0)
        X = _paths(cuda_device, 8, L, 2)
        K64, dX64 = kern.gram_and_grad(X.cpu().double())
        for K, dX in (kern.gram_and_grad(X), kern.gram_and_grad(X.cpu())):
            torch.testing.assert_close(K.cpu().double(), K64, rtol=1e-3, atol=0)
            scale = dX64.abs().max()
            torch.testing.assert_close(dX.cpu().double() / scale, dX64 / scale,
                                       rtol=0, atol=3e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(40, 9, 2), (37, 13, 2), (7, 5, 3), (20, 40, 2),
                                   (2, 49, 3), (19, 30, 1), (6, 64, 3),
                                   # one coarse column; 37 columns (a prime) over 8
                                   # lanes; L = 64 at C = 3 over 16 lanes; n = 2
                                   (9, 2, 2), (50, 38, 2), (33, 64, 3), (2, 40, 2),
                                   # C = 4..8 (span template 3): the planner's
                                   # knots, each C at L·C = 128, n = 2
                                   (128, 3, 7), (40, 16, 8), (33, 32, 4), (77, 18, 7),
                                   (20, 25, 5), (19, 21, 6), (2, 2, 8), (30, 9, 4)])
def test_k2_matches_plain_twin_on_the_card(cuda_device, n, L, C):
    X = _paths(cuda_device, n, L, C)
    before = kb3.block3_gram_and_grad.launches
    K, dX = kb3.block3_gram_and_grad(X, 4.0)
    assert kb3.block3_gram_and_grad.launches == before + 1
    Kp, _ = kb3.block3_gram_and_grad_plain(X, 4.0)
    # dX against the twin in fp64: the fp32 twin's own dX may sit ~4e-4
    # (scaled) from it at λ=3
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 4.0)
    _assert_k_dx(K.cpu(), dX.double().cpu(), Kp.cpu(), dX64.cpu(), 1e-4, 4e-4)
    torch.testing.assert_close(kb3.block3_gram_plain(X, 4.0).cpu(), Kp.cpu(),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 9, 2), (777, 13, 3), (1023, 40, 2), (1024, 16, 8),
                                   (1024, 32, 4)])
def test_k2_blocks_taking_many_tiles_match_plain_twin(cuda_device, n, L, C):
    """More tiles than resident blocks: each persistent block reuses its
    scratch and shared slots from one tile to the next (at n = 1023 the
    flagship width with a ragged last tile). The twin takes the pairs a chunk
    at a time to bound its memory."""
    X = _paths(cuda_device, n, L, C)
    tiles, blocks = kb3.block3_grid(n, L, C, cuda_device)
    assert tiles.shape[0] > 2 * blocks
    assert tiles.shape[0] == kb3.block3_plan(n, L, C, blocks).tiles
    K, dX = kb3.block3_gram_and_grad(X, 4.0)
    Kp = kb3.block3_gram_plain(X, 4.0)
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 4.0,
                                             pairs_per_chunk=4096 if L > 20 else 16384)
    _assert_k_dx(K.cpu(), dX.double().cpu(), Kp.cpu(), dX64.cpu(), 1e-4, 4e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 40, 2), (77, 41, 3), (1024, 3, 7), (130, 32, 4)])
def test_k2_is_bitwise_repeatable(cuda_device, n, L, C):
    """No atomics and fixed-order sums: two calls give the same K and dX bit
    for bit."""
    X = _paths(cuda_device, n, L, C)
    K1, dX1 = kb3.block3_gram_and_grad(X, 4.0)
    K2, dX2 = kb3.block3_gram_and_grad(X, 4.0)
    assert torch.equal(K1, K2) and torch.equal(dX1, dX2)


def _maze_tau(device, n):
    """τ of the maze's sampled rollouts ([n, 30, 2] XY paths, averaged over
    10 action samples) and the signature kernel's bandwidth √32."""
    from sigsvgd_tpu_torch.experiments import maze

    cfg = maze.MazeConfig(n_policies=n - maze.N_PRIM)
    model = maze.make_model(cfg, device)
    ctrl = maze.build_controller(cfg, model)
    draws = maze.sample_draws(dataclasses.replace(cfg, steps=1),
                              torch.Generator(device=device).manual_seed(n))
    cs = ctrl.init(pol_mean=draws.pol_mean,
                   action_primitives=maze.action_primitives(cfg.horizon, device))
    eps = draws.steps[0].actions[0] @ torch.linalg.cholesky(ctrl._pol_cov()).T
    state = torch.tensor(model.init_state, device=device)
    with torch.no_grad():
        trajs = ctrl._rollout_costs(state, cs.pol_mean[None] + eps)[1]
    return ctrl._tau(trajs).contiguous(), ctrl.sig_kernel.bandwidth


@pytest.mark.cuda
@pytest.mark.parametrize("n", [35, 36])
def test_k2_at_the_maze_shape(cuda_device, n):
    """K2 at the maze's [35, 30, 2] (630 pairs: a ragged last tile row and
    diagonal tile) and [36, 30, 2] on the maze's own τ at h = √32: K atol
    1e-4 against the fp32 twin; dX against the twin in fp64 at K2's scaled
    4e-4 or, where the fp32 twin is itself farther from fp64, at 1.1 times
    the twin's distance (on these paths the twin's dX was 9.19e-4 from fp64
    on the card, K2's 9.19e-4; ``chip_smoke.py``'s ``k2_maze_shape``)."""
    X, h = _maze_tau(cuda_device, n)
    assert tuple(X.shape) == (n, 30, 2)
    before = kb3.block3_gram_and_grad.launches
    K, dX = kb3.block3_gram_and_grad(X, h)
    assert kb3.block3_gram_and_grad.launches == before + 1
    Kp, dXp = kb3.block3_gram_and_grad_plain(X, h)
    torch.testing.assert_close(K, Kp, atol=1e-4, rtol=0)
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), h)
    scale = dX64.abs().max()
    far = lambda d: ((d.double() - dX64).abs().max() / scale).item()  # noqa: E731
    assert far(dX) <= max(4e-4, 1.1 * far(dXp))
    torch.testing.assert_close(K, K.T, rtol=0, atol=0)


@pytest.mark.cuda
def test_maze_episode_matches_cpu(cuda_device):
    """A 3-step maze episode (signature kernel, MPF on; 11 + 5 policies,
    H = 12) on the card and on the CPU with the same draws: 2 K2 launches a
    step on the card, none on the CPU; states atol 2e-5 and actions atol
    1e-3 (K2 and its twin differ within ``K2_TOL``, and Adam at lr 1 passes
    that on to the policies at about its size), the MPF's particles atol
    1e-4. An episode may part at a crash: a rollout point within an ulp of
    an obstacle cell's edge (``tests/test_torch_maze.py``)."""
    from sigsvgd_tpu_torch.experiments import maze

    cfg = maze.MazeConfig(kernel="signature", use_mpf=True, n_policies=11, horizon=12,
                          steps=3)
    draws = maze.sample_draws(cfg, torch.Generator().manual_seed(4))
    res = {}
    for dev in (cuda_device, "cpu"):
        before = kb3.block3_gram_and_grad.launches
        res[dev] = maze.run_episode(cfg, 0, device=dev, draws=draws.to(dev))
        res[dev]["launches"] = kb3.block3_gram_and_grad.launches - before
    g, c = res[cuda_device], res["cpu"]
    assert (g["launches"], c["launches"]) == (2 * cfg.steps, 0)
    assert g["steps"] == c["steps"] == cfg.steps
    np.testing.assert_allclose(g["trajectory"], c["trajectory"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(g["actions"], c["actions"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(g["dyn_particles"], c["dyn_particles"], rtol=0, atol=1e-4)


def _k9_inputs(device, N, D, scale=1.0):
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.rand((N, D), generator=g, device=device) * 4.0 - 2.0
    s = torch.randn((N, D), generator=g, device=device) * scale
    return x, s, bw_median(pw_dist_sq(x, x))  # the sampler's bandwidth


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,scale", [
    (1024, 280, 1.0), (333, 280, 1.0), (50, 17, 1.0), (40, 400, 1.0), (64, 700, 1.0),
    (1024, 840, 1.0), (1024, 1400, 1.0), (77, 1025, 1.0), (1024, 280, 100.0), (1, 1, 1.0),
    (12000, 7, 1.0)])
def test_k9_matches_plain_twin_on_the_card(cuda_device, N, D, scale):
    """[12000, 7] takes 19 row chunks of K; scores 100 times larger are
    where single-pass TF32 on K·[s | x] would miss the tolerance."""
    x, s, h = _k9_inputs(cuda_device, N, D, scale)
    before = kv.fused_rbf_velocity.launches
    phi = kv.fused_rbf_velocity(x, s, h)
    assert kv.fused_rbf_velocity.launches == before + 1
    want = kv.rbf_velocity_plain(x, s, h)
    torch.testing.assert_close(phi.cpu(), want.cpu(), rtol=2e-4, atol=5e-5)


@pytest.mark.cuda
def test_k9_column_chunks_match_plain_twin(cuda_device, monkeypatch):
    """A 64 KiB cap cuts N = 300 into 3 × 3 chunks of 128: the column
    chunks' terms add into φ in order."""
    monkeypatch.setattr(kv, "CHUNK_BYTES", 64 << 10)
    assert kv.velocity_plan(300, 37)[:4] == (128, 128, 3, 3)
    x, s, h = _k9_inputs(cuda_device, 300, 37)
    torch.testing.assert_close(kv.fused_rbf_velocity(x, s, h).cpu(),
                               kv.rbf_velocity_plain(x, s, h).cpu(), rtol=2e-4, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(1024, 280), (12000, 7)])
def test_k9_is_bitwise_repeatable(cuda_device, N, D):
    x, s, h = _k9_inputs(cuda_device, N, D)
    assert torch.equal(kv.fused_rbf_velocity(x, s, h), kv.fused_rbf_velocity(x, s, h))


@pytest.mark.cuda
def test_k9_counts_one_launch_a_call(cuda_device):
    """The counter counts calls, whatever the number of chunks."""
    for N, D in ((1024, 280), (12000, 7), (1, 1)):
        x, s, h = _k9_inputs(cuda_device, N, D)
        before = kv.fused_rbf_velocity.launches
        kv.fused_rbf_velocity(x, s, h)
        kv.fused_rbf_velocity(x, s, h)
        assert kv.fused_rbf_velocity.launches == before + 2


def _knot_increments(device, n, lam_paths=3, seed=0):
    """Increments of the planning Gram: ``n`` knot paths [n, 3, 7] uniform
    in ±2.5 rad, RBF statics at h = 1.5 → ``[n², 2, 2]``."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = (torch.rand((n, lam_paths, 7), generator=g, device=device) - 0.5) * 5.0
    inc = gram_increments(torch.exp(-_pair_sq_dists(X, X) / 1.5))
    return inc.reshape(n * n, lam_paths - 1, lam_paths - 1).contiguous()


def _clipped_normal(device, b, lx1, ly1, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, lx1, ly1), generator=g, device=device).clamp(-2, 2)


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["planning_131072x2x2_l6", "ragged_389x4x4_l6",
                                  "sub2_1000x2x2_l7"])
def test_k8_matches_plain_twin_on_the_card(cuda_device, case):
    if case.startswith("planning"):
        inc, lam = _knot_increments(cuda_device, 363)[:131072], 6
    elif case.startswith("ragged"):
        inc, lam = _clipped_normal(cuda_device, 389, 4, 4), 6
    else:
        inc, lam = _clipped_normal(cuda_device, 1000, 2, 2), 7
    g = torch.randn(inc.shape[0], generator=torch.Generator(device=cuda_device)
                    .manual_seed(5), device=cuda_device)
    before = (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches)
    t = inc.clone().requires_grad_(True)
    k = mc.solve_goursat_pde_mxu_chain(t, lam)
    (d,) = torch.autograd.grad(k, t, g)
    assert (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tp = inc.clone().requires_grad_(True)
    kp = mc.solve_goursat_pde_mxu_chain_plain(tp, lam)
    (dp,) = torch.autograd.grad(kp, tp, g)
    assert torch.isfinite(k).all() and torch.isfinite(d).all()
    assert _scaled(k, kp) <= 1e-3
    assert _scaled(d, dp) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,lx1,ly1,lam", [
    (130, 2, 2, 6),      # ragged: two warpgroups' worth of tiles is 128 pairs
    (40000, 2, 2, 6),    # two warpgroups a block, more tiles than resident blocks
    (1000, 4, 4, 6),     # 16 hops, the kept inputs in device scratch
    (700, 2, 2, 7),      # sub = 2
    (200, 8, 8, 6),      # MAX_HOPS
    (77, 1, 1, 6),       # one hop
])
def test_k8_wgmma_design_matches_plain_twin(cuda_device, B, lx1, ly1, lam):
    """The redesigned K8 (pairs on wgmma's M side, a producer warp's ring of
    staged slices, one reverse pass a degree) against its twin, at the
    plan's corners: one and two consumer warpgroups, a ragged last tile,
    persistent blocks over several tiles, north rows and kept inputs in
    shared memory and in device scratch, 1 to 64 hops."""
    inc = _clipped_normal(cuda_device, B, lx1, ly1, seed=B)
    inc[1] = 0.0    # a zero-increment pair
    g = torch.randn(B, generator=torch.Generator(device=cuda_device).manual_seed(7),
                    device=cuda_device)
    nbx, nby, _ = mc._geometry(lx1, ly1, lam)
    plan = mc.device_plan(B, lx1 * ly1, nbx, nby, 10, True, cuda_device)
    if B == 40000:
        assert plan.warpgroups == 2 and plan.tiles > plan.blocks
    t = inc.clone().requires_grad_(True)
    k = mc.solve_goursat_pde_mxu_chain(t, lam)
    (d,) = torch.autograd.grad(k, t, g)
    tp = inc.clone().requires_grad_(True)
    kp = mc.solve_goursat_pde_mxu_chain_plain(tp, lam)
    (dp,) = torch.autograd.grad(kp, tp, g)
    assert torch.isfinite(k).all() and torch.isfinite(d).all()
    assert _scaled(k, kp) <= 1e-3
    assert _scaled(d, dp) <= 2e-3


@pytest.mark.cuda
def test_k8_is_bitwise_repeatable(cuda_device):
    """Pairs are independent and their sums run in a fixed order: k and dz
    bit for bit across two calls."""
    inc = _clipped_normal(cuda_device, 40000, 2, 2, seed=3)
    z = (inc / 4.0 ** 6).reshape(40000, 4).contiguous()
    g = torch.randn(40000, generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    k1, k2 = (mc.mxu_chain_fwd(z, 2, 2, 1, 2) for _ in range(2))
    d1, d2 = (mc.mxu_chain_bwd(z, g, 2, 2, 1, 2) for _ in range(2))
    assert torch.equal(k1, k2) and torch.equal(d1, d2)


@pytest.mark.cuda
def test_k8_raises_outside_its_envelope(cuda_device):
    with pytest.raises(ValueError, match="block hops"):
        mc.solve_goursat_pde_mxu_chain(torch.zeros(4, 9, 9, device=cuda_device), 6)
    with pytest.raises(ValueError, match="dyadic_order"):
        mc.solve_goursat_pde_mxu_chain(torch.zeros(4, 2, 2, device=cuda_device), 5)
    with pytest.raises(ValueError, match="hops"):
        mc.mxu_chain_fwd(torch.zeros(4, 81, device=cuda_device), 9, 9, 1, 9)


@pytest.mark.cuda
def test_k8_launches_once_each_per_gram_and_grad(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    X = (torch.rand((1024, 3, 7), generator=g, device=cuda_device) - 0.5) * 5.0
    before = (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches)
    K, dX = SignatureKernel(6, 1.5, mxu_precision="default").gram_and_grad(X)
    torch.cuda.synchronize()
    assert (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert K.shape == (1024, 1024) and dX.shape == (1024, 3, 7)
    assert torch.isfinite(K).all() and torch.isfinite(dX).all()


def _pair_tiles(device, P, Lx, Ly, C, seed=0):
    """Scaled tiles of ``P`` random pairs of joint-angle-like paths at
    h = 4: ``xt [Lx, C, P]``, ``yt [Ly, C, P]``."""
    X = _paths(device, 64, Lx, C, seed) * 0.5
    Y = _paths(device, 64, Ly, C, seed + 1) * 0.5
    g = torch.Generator(device=device).manual_seed(seed + 2)
    ix = torch.randint(0, 64, (P,), generator=g, device=device)
    iy = torch.randint(0, 64, (P,), generator=g, device=device)
    return (X[ix].permute(1, 2, 0).contiguous(), Y[iy].permute(1, 2, 0).contiguous(),
            torch.randn(P, generator=g, device=device))


def _rel_cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return ((a - b).norm() / b.norm()).item(), (a @ b / (a.norm() * b.norm())).item()


@pytest.mark.cuda
@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("Lx,Ly", [(40, 40), (23, 9)])
def test_k4_matches_plain_twin_on_the_card(cuda_device, C, Lx, Ly):
    xt, yt, gout = _pair_tiles(cuda_device, 300, Lx, Ly, C)
    before = (kf.fused_forward.launches, kf.fused_backward.launches)
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    dx, dy = kf.fused_backward(xt, yt, ck, rc, gout)
    assert (kf.fused_forward.launches, kf.fused_backward.launches) == (
        before[0] + 1, before[1] + 1)
    (k_values_only,) = kf.fused_forward(xt, yt, residuals=False)
    kp, ckp, rcp = kf.fused_forward_plain(xt, yt, residuals=True)
    _, dx64, dy64 = kf.fused_pairs_plain(xt.double(), yt.double(), gout.double())
    torch.testing.assert_close(k, kp, atol=1e-4, rtol=0)
    torch.testing.assert_close(k_values_only, k, atol=0, rtol=0)
    torch.testing.assert_close(ck, ckp, atol=1e-4, rtol=0)
    torch.testing.assert_close(rc, rcp, atol=1e-4, rtol=0)
    for got, want in ((dx, dx64), (dy, dy64)):
        scale = want.abs().max()
        torch.testing.assert_close(got.double() / scale, want / scale, atol=4e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,Lx,Ly,P", [(C, 12, 9, 200) for C in range(1, 5)]
                         + [(2, 40, 40, 200), (4, 41, 41, 201), (3, 41, 33, 77)])
def test_k6_matches_plain_twin_on_the_card(cuda_device, C, Lx, Ly, P):
    """Every instantiation (C ≤ 4) at short paths (the twin's delta chains
    take 8·lx1·8·ly1 sequential steps), and the flagship and bf16-envelope
    lengths; an odd pair count leaves the last thread one pair."""
    xt, yt, gout = _pair_tiles(cuda_device, P, Lx, Ly, C, seed=3)
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    before = kf.fused_backward_bf16.launches
    dx, dy = kf.fused_backward_bf16(xt, yt, ck, rc, gout)
    assert kf.fused_backward_bf16.launches == before + 1
    dxp, dyp = kf.fused_backward_bf16_plain(xt, yt, ck, rc, gout)
    dx32, dy32 = kf.fused_backward(xt, yt, ck, rc, gout)
    got, twin = torch.cat([dx.flatten(), dy.flatten()]), torch.cat([dxp.flatten(), dyp.flatten()])
    fp32 = torch.cat([dx32.flatten(), dy32.flatten()])
    rel, cos = _rel_cos(got, twin)
    assert rel <= 2e-2 and cos >= 0.999, (rel, cos)
    rel, cos = _rel_cos(got, fp32)
    assert rel < 0.25 and cos > 0.98, (rel, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_backwards_solve_every_pass_of_their_persistent_loop(cuda_device, bf16):
    """More pairs than the backward's persistent blocks take at once, so its
    loop runs three passes, the last a partial one, over the tiles of its
    plan: K4's backward runs of pairs, K6 runs of pair couples, its last
    couple a lone pair; every pair is held against the twin."""
    L, C = 6, 2
    part = "bf16" if bf16 else "backward"
    plan = kf.launch_plan(1 << 24, L - 1, L - 1, C, part, cuda_device)
    P = plan.pairs_per_tile * 2 * plan.blocks + plan.pairs_per_tile // 2 + 1
    plan = kf.launch_plan(P, L - 1, L - 1, C, part, cuda_device)
    assert plan.passes == 3 and plan.tiles % plan.blocks and P % 2
    xt, yt, gout = _pair_tiles(cuda_device, P, L, L, C, seed=5)
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    if bf16:
        dx, dy = kf.fused_backward_bf16(xt, yt, ck, rc, gout)
        dxp, dyp = kf.fused_backward_bf16_plain(xt, yt, ck, rc, gout)
        rel, cos = _rel_cos(torch.cat([dx.flatten(), dy.flatten()]),
                            torch.cat([dxp.flatten(), dyp.flatten()]))
        assert rel <= 2e-2 and cos >= 0.999, (rel, cos)
        return
    dx, dy = kf.fused_backward(xt, yt, ck, rc, gout)
    for c0 in range(0, P, 32768):
        sl = slice(c0, c0 + 32768)
        _, dx64, dy64 = kf.fused_pairs_plain(xt[..., sl].double(), yt[..., sl].double(),
                                             gout[sl].double())
        for got, want in ((dx[..., sl], dx64), (dy[..., sl], dy64)):
            scale = want.abs().max()
            torch.testing.assert_close(got.double() / scale, want / scale, atol=4e-4, rtol=0)


def _held(P, n=4096):
    """The first and last ``n`` pairs of ``P``."""
    return torch.cat([torch.arange(min(n, P)), torch.arange(max(min(n, P), P - n), P)]).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("P,Lx,Ly,C", [(1001, 40, 40, 2), (150_001, 40, 40, 2),
                                       (333, 9, 49, 8), (257, 23, 49, 3), (300, 12, 6, 4),
                                       (77, 3, 2, 1), (1, 40, 40, 2)])
def test_k4_forward_lanes_match_the_twin(cuda_device, P, Lx, Ly, C):
    """K4's forward, a lane group per pair: a ragged P, more tiles than
    resident blocks (150,001 pairs: each block's loop takes several tiles),
    ly1 = 48 (16 lanes a pair), ly1 ≤ 5 (one lane a pair), a single pair.
    k, ck and rc are the twin's bit for bit (the statics and the sweep round
    as the twin does, and the card's exp matched the twin's on every pair
    held) on the first and last 4,096 pairs; the values-only call gives the
    same k."""
    xt, yt, _ = _pair_tiles(cuda_device, P, Lx, Ly, C, seed=11)
    plan = kf.launch_plan(P, Lx - 1, Ly - 1, C, "forward", cuda_device)
    if P > 100_000:
        assert plan.tiles > plan.blocks
    before = kf.fused_forward.launches
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    (k_values_only,) = kf.fused_forward(xt, yt, residuals=False)
    assert kf.fused_forward.launches == before + 2
    held = _held(P)
    kp, ckp, rcp = kf.fused_forward_plain(xt[..., held], yt[..., held], residuals=True)
    assert torch.equal(k[held], kp) and torch.equal(k_values_only, k)
    assert torch.equal(ck[..., held], ckp) and torch.equal(rc[..., held], rcp)


@pytest.mark.cuda
@pytest.mark.parametrize("C", range(1, 5))
def test_k6_lanes_at_the_bf16_envelope(cuda_device, C):
    """K6, a lane group per pair couple, at ly1 = 40 (8 lanes of 5 coarse
    columns) with an odd P (a lone pair in the last couple) and Lx ≠ Ly,
    against its bf16 twin (rel ≤ 2e-2, cos ≥ 0.999) and K4's fp32 backward
    (rel < 0.25, cos > 0.98)."""
    xt, yt, gout = _pair_tiles(cuda_device, 301, 14, 41, C, seed=13)
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    dx, dy = kf.fused_backward_bf16(xt, yt, ck, rc, gout)
    dxp, dyp = kf.fused_backward_bf16_plain(xt, yt, ck, rc, gout)
    dx32, dy32 = kf.fused_backward(xt, yt, ck, rc, gout)
    got = torch.cat([dx.flatten(), dy.flatten()])
    rel, cos = _rel_cos(got, torch.cat([dxp.flatten(), dyp.flatten()]))
    assert rel <= 2e-2 and cos >= 0.999, (rel, cos)
    rel, cos = _rel_cos(got, torch.cat([dx32.flatten(), dy32.flatten()]))
    assert rel < 0.25 and cos > 0.98, (rel, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("P,Lx,Ly,C", [(20_001, 40, 40, 2), (301, 14, 41, 4)])
def test_fused_lanes_are_bitwise_repeatable(cuda_device, P, Lx, Ly, C):
    """No atomics: k, ck, rc and K6's dx, dy bit for bit across two calls."""
    xt, yt, gout = _pair_tiles(cuda_device, P, Lx, Ly, C, seed=17)
    k1, ck1, rc1 = kf.fused_forward(xt, yt, residuals=True)
    k2, ck2, rc2 = kf.fused_forward(xt, yt, residuals=True)
    assert torch.equal(k1, k2) and torch.equal(ck1, ck2) and torch.equal(rc1, rc2)
    dx1, dy1 = kf.fused_backward_bf16(xt, yt, ck1, rc1, gout)
    dx2, dy2 = kf.fused_backward_bf16(xt, yt, ck1, rc1, gout)
    assert torch.equal(dx1, dx2) and torch.equal(dy1, dy2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,Lx,Ly,C", [(20_001, 40, 40, 2), (301, 14, 41, 4), (257, 9, 49, 8)])
def test_k4_backward_is_bitwise_repeatable(cuda_device, P, Lx, Ly, C):
    """No atomics and a fixed order of every sum: K4's backward gives dx and
    dy bit for bit across two calls, over several tiles a block and at 8
    and 16 lanes a pair."""
    xt, yt, gout = _pair_tiles(cuda_device, P, Lx, Ly, C, seed=19)
    _, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    dx1, dy1 = kf.fused_backward(xt, yt, ck, rc, gout)
    dx2, dy2 = kf.fused_backward(xt, yt, ck, rc, gout)
    assert torch.equal(dx1, dx2) and torch.equal(dy1, dy2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,Lx", [(333, 9), (64, 14)])
def test_k4_backward_at_sixteen_lanes_and_eight_channels(cuda_device, P, Lx):
    """The span-3 template at its corner: ly1 = 48 (16 lanes of 3 coarse
    columns a pair) with C = 8, the y points and column-path gradients in
    shared memory; lx1 = 8 (two checkpoint slots, 6 + 2) and 13 (three):
    dx and dy within K2's scaled 4e-4 of the twin in fp64, as K4's card
    tests."""
    xt, yt, gout = _pair_tiles(cuda_device, P, Lx, 49, 8, seed=23)
    plan = kf.launch_plan(P, Lx - 1, 48, 8, "backward", cuda_device)
    assert (plan.g, plan.span, max(plan.spans)) == (16, 3, 3)
    _, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    dx, dy = kf.fused_backward(xt, yt, ck, rc, gout)
    _, dx64, dy64 = kf.fused_pairs_plain(xt.double(), yt.double(), gout.double())
    for got, want in ((dx, dx64), (dy, dy64)):
        scale = want.abs().max()
        torch.testing.assert_close(got.double() / scale, want / scale, atol=4e-4, rtol=0)


@pytest.mark.cuda
def test_dense_lambda3_gram_runs_k4_with_the_median_bandwidth(cuda_device, monkeypatch):
    """``gram(X, Y)`` at λ=3 below the dense limit on the card, as the JAX
    package routes it: the dense static Gram (the bandwidth the median of the
    whole dense distance tensor), its increments and K5 over all n·m pairs,
    one forward and one backward, and no K4 (which this route took before
    K5 existed). K against the CPU's same route, K5's twin (atol 5e-4, the
    tolerance this route had); dX against the same route on the card with
    the fp64 twin in K5's backward's place (scaled 1e-3, the JAX package's
    tolerance for this route's gradient: the median's gradient sums all 408
    pairs' bandwidth gradients onto one path point, and their fp32 rounding
    with them) and, at a fixed bandwidth, against the CPU's route (scaled
    1e-3)."""
    X, Y = _paths(cuda_device, 24, 40, 2), _paths(cuda_device, 17, 33, 2, seed=1)
    assert 24 * 17 * 40 * 33 <= SignatureKernel._DENSE_LIMIT
    median, fixed = SignatureKernel(3, bandwidth=None), SignatureKernel(3, bandwidth=0.2)

    def run(dev, kern):
        x = X.to(dev, copy=True).requires_grad_(True)
        K = kern.gram(x, Y.to(dev))
        (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach().cpu(), dX.cpu()

    counters = (kt.tiled_forward, kt.tiled_backward, kf.fused_forward, kf.fused_backward)
    before = [c.launches for c in counters]
    K, dX = run(cuda_device, median)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    assert K.shape == (24, 17) and torch.isfinite(dX).all()
    torch.testing.assert_close(K, run("cpu", median)[0], atol=5e-4, rtol=0)
    _assert_k_dx(*run(cuda_device, fixed), *run("cpu", fixed), k_atol=5e-4, dx_atol=1e-3)
    monkeypatch.setattr(kt, "tiled_backward", lambda z, ck, g: kt.tiled_backward_plain(
        z.double(), kt.twin_checkpoints(ck, *z.shape).double(), g.double()).float())
    _assert_k_dx(K, dX, *run(cuda_device, median), k_atol=0, dx_atol=1e-3)


@pytest.mark.cuda
def test_bf16_gram_and_grad_launches_k4_forward_and_k6_once_each(cuda_device, monkeypatch):
    """One bf16 ``gram_and_grad`` launches K4's forward and K6 once each and
    neither K2 nor K4's backward; its K is K2's (atol 1e-4) and its dX is
    the same route's with K6's twin in K6's place (rel ≤ 2e-2, cos ≥
    0.999). Against K2's fp32 dX the summed gradient of these smooth paths
    is ~20% off, the delta-form method's error (the twin's distance from the
    fp32 gradient is JAX's own, ``tests/test_torch_fused_bf16.py``), so that
    is not held here."""
    X = _paths(cuda_device, 300, 40, 2)
    counters = (kf.fused_forward, kf.fused_backward, kf.fused_backward_bf16,
                kb3.block3_gram_and_grad)
    before = [c.launches for c in counters]
    kern = SignatureKernel(3, 4.0, grad_precision="bf16")
    K, dX = kern.gram_and_grad(X)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0, 1, 0]
    K32, _ = SignatureKernel(3, 4.0).gram_and_grad(X)   # K2
    torch.testing.assert_close(K, K32, atol=1e-4, rtol=0)
    monkeypatch.setattr(kf, "fused_backward_bf16", kf.fused_backward_bf16_plain)
    _, dX_twin = kern.gram_and_grad(X)
    rel, cos = _rel_cos(dX, dX_twin)
    assert rel <= 2e-2 and cos >= 0.999, (rel, cos)


@pytest.mark.cuda
def test_fused_kernels_raise_outside_their_envelope(cuda_device):
    with pytest.raises(NotImplementedError, match="wavefront"):  # ly1 = 49
        kf.fused_forward(torch.zeros(5, 2, 4, device=cuda_device),
                         torch.zeros(50, 2, 4, device=cuda_device), residuals=False)
    with pytest.raises(NotImplementedError, match="pair_values"):  # C = 9: K5's route
        kf.fused_forward(torch.zeros(5, 9, 4, device=cuda_device),
                         torch.zeros(5, 9, 4, device=cuda_device), residuals=False)
    xt = torch.zeros(5, 5, 4, device=cuda_device)               # C = 5 in bf16
    with pytest.raises(ValueError, match="K6 takes"):
        kf.fused_backward_bf16(xt, xt, *kf.fused_forward(xt, xt, residuals=True)[1:],
                               torch.zeros(4, device=cuda_device))
    yt = torch.zeros(42, 2, 4, device=cuda_device)              # ly1 = 41 in bf16
    with pytest.raises(ValueError, match="K6 takes"):
        kf.fused_backward_bf16(xt[:, :2].contiguous(), yt,
                               *kf.fused_forward(xt[:, :2].contiguous(), yt, residuals=True)[1:],
                               torch.zeros(4, device=cuda_device))
    # C = 9 solves through K5 on the card, as its twin on the CPU
    X = _paths(cuda_device, 4, 5, 9)
    before = (kt.tiled_forward.launches, kt.tiled_backward.launches)
    K, dX = SignatureKernel(3, 4.0).gram_and_grad(X)
    assert (kt.tiled_forward.launches, kt.tiled_backward.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_k_dx(K.cpu(), dX.cpu(), *SignatureKernel(3, 4.0).gram_and_grad(X.cpu()),
                 k_atol=1e-4, dx_atol=5e-4)


def _assert_k7(xt, yt, gout):
    """K7's forward (values only and with the residual) and backward against
    the fp32 twin."""
    (k_values_only,) = ks.small_forward(xt, yt, residuals=False)
    k, fac = ks.small_forward(xt, yt, residuals=True)
    dx, dy = ks.small_backward(xt, yt, fac, gout)
    kp, facp = ks.small_forward_plain(xt, yt, residuals=True)
    dxp, dyp = ks.small_backward_plain(xt, yt, facp, gout)
    torch.testing.assert_close(k, kp, atol=3e-5, rtol=0)
    torch.testing.assert_close(k_values_only, k, atol=0, rtol=0)
    torch.testing.assert_close(fac, facp, atol=3e-5, rtol=0)
    for got, want in ((dx, dxp), (dy, dyp)):
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, atol=5e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("Lx,Ly", [(40, 40), (23, 9), (5, 64), (41, 17)])
def test_k7_matches_plain_twin_on_the_card(cuda_device, C, Lx, Ly):
    xt, yt, gout = _pair_tiles(cuda_device, 300, Lx, Ly, C)
    before = (ks.small_forward.launches, ks.small_backward.launches)
    _assert_k7(xt, yt, gout)
    assert (ks.small_forward.launches, ks.small_backward.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_k7_solves_every_pass_of_its_persistent_loops(cuda_device):
    """More pairs than the tiles the resident blocks of any of K7's three
    launches take at once, so each persistent loop runs three or more
    passes, the last over a partial tile; every pair is held against the
    twin."""
    L, C = 40, 2
    full = [ks.launch_plan(L - 1, L - 1, C, 1 << 24, part, cuda_device) for part in ks.PARTS]
    P = 2 * max(plan.blocks * plan.pairs_per_tile for plan in full) + 37
    for part in ks.PARTS:
        plan = ks.launch_plan(L - 1, L - 1, C, P, part, cuda_device)
        assert plan.passes >= 3 and P % plan.pairs_per_tile != 0, plan
    xt, yt, gout = _pair_tiles(cuda_device, P, L, L, C, seed=5)
    _assert_k7(xt, yt, gout)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("Lx,Ly", [(2, 40), (40, 2), (2, 2), (2, 64), (64, 2)])
def test_k7_at_one_row_or_one_column(cuda_device, C, Lx, Ly):
    """The grid's edges: one row of cells (lx1 = 1: a pair's start is its
    end), one column (ly1 = 1: one lane) and one cell, at an odd P."""
    xt, yt, gout = _pair_tiles(cuda_device, 301, Lx, Ly, C, seed=7)
    _assert_k7(xt, yt, gout)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,Ly,C", [(40, 40, 2), (64, 64, 8), (23, 9, 3)])
def test_k7_backward_is_bitwise_repeatable(cuda_device, Lx, Ly, C):
    """No atomics: two backward calls on one residual give dx and dy bit for
    bit (and two forwards k and fac)."""
    xt, yt, gout = _pair_tiles(cuda_device, 5003, Lx, Ly, C, seed=9)
    k, fac = ks.small_forward(xt, yt, residuals=True)
    k2, fac2 = ks.small_forward(xt, yt, residuals=True)
    dx, dy = ks.small_backward(xt, yt, fac, gout)
    dx2, dy2 = ks.small_backward(xt, yt, fac, gout)
    for a, b in ((k, k2), (fac, fac2), (dx, dx2), (dy, dy2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [
    # L = 64 at L·C = 128 (K3's envelope ends at L·C ≤ 128; [40, 64, 3] left it)
    (1024, 40, 2), (333, 40, 2), (33, 21, 3), (7, 5, 3), (40, 64, 2),
    # C = 4..8 (K3 alone): L·C = 128 in the 16- and 40-node buckets, 4,160
    # tiles (more than the card's resident blocks), a bucket's shortest
    # path, L = 2
    (1024, 16, 8), (300, 32, 4), (77, 18, 7), (50, 25, 5), (64, 21, 6), (20, 64, 1),
    (9, 41, 3), (5, 2, 8), (130, 17, 4)])
def test_k3_equals_k1_and_its_twin_on_the_card(cuda_device, n, L, C):
    """K3 gives the twin's K bit for bit at every instantiation's shapes
    (the statics and the sweep round as the twin does), and K1's: K1 takes
    every shape of K3's envelope, C = 4..8 included."""
    X = _paths(cuda_device, n, L, C)
    before = kb.block_gram.launches
    K = kb.block_gram(X, 4.0)
    assert kb.block_gram.launches == before + 1
    assert kb.block_supported(n, L, C, 4.0)
    K1, _ = kb.block_gram_and_grad(X, 4.0)
    torch.testing.assert_close(K, K1, atol=0, rtol=0)
    torch.testing.assert_close(K, kb.block_gram_plain(X, 4.0), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 40, 2), (1024, 16, 8), (97, 64, 1)])
def test_k3_is_bitwise_repeatable(cuda_device, n, L, C):
    X = _paths(cuda_device, n, L, C)
    assert torch.equal(kb.block_gram(X, 4.0), kb.block_gram(X, 4.0))


def _launches():
    return {f.__name__: f.launches for f in (
        ks.small_forward, ks.small_backward, kb.block_gram, kb.block_gram_and_grad,
        kb3.block3_gram_and_grad, kf.fused_forward, kf.fused_backward)}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


@pytest.mark.cuda
def test_lambda0_streamed_gram_launches_k7_only(cuda_device, monkeypatch):
    """``gram(X, Y)`` above the dense limit at λ=0: one chunk, K7's forward
    twice (values, then with the residual in the backward) and its backward
    once, nothing else; K and dX against the CPU's (the twins), atol 3e-5 and
    scaled 5e-5."""
    monkeypatch.setattr(SignatureKernel, "_DENSE_LIMIT", 1000)
    X, Y = _paths(cuda_device, 24, 40, 2), _paths(cuda_device, 17, 33, 2, seed=1)
    kern = SignatureKernel(0, bandwidth=None)

    def run(dev):
        x = X.to(dev, copy=True).requires_grad_(True)
        K = kern.gram(x, Y.to(dev))
        (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach().cpu(), dX.cpu()

    before = _launches()
    K, dX = run(cuda_device)
    torch.cuda.synchronize()
    assert _delta(before) == {"small_forward": 2, "small_backward": 1}
    _assert_k_dx(K, dX, *run("cpu"))


@pytest.mark.cuda
def test_gram_sym_launches_k3_at_lambda0_and_k7_outside_the_block(cuda_device):
    X = _paths(cuda_device, 300, 40, 2)
    before = _launches()
    K = SignatureKernel(0, 4.0).gram_sym(X)
    torch.cuda.synchronize()
    assert _delta(before) == {"block_gram": 1}
    torch.testing.assert_close(K, kb.block_gram_and_grad(X, 4.0)[0], atol=0, rtol=0)
    X = _paths(cuda_device, 20, 41, 4)                    # L·C > 128
    x = X.clone().requires_grad_(True)
    before = _launches()
    K = SignatureKernel(0, 4.0).gram_sym(x)
    (dX,) = torch.autograd.grad(K.sum(), x)
    torch.cuda.synchronize()
    assert _delta(before) == {"small_forward": 2, "small_backward": 1}
    x = X.cpu().requires_grad_(True)
    Kc = SignatureKernel(0, 4.0).gram_sym(x)
    (dXc,) = torch.autograd.grad(Kc.sum(), x)
    _assert_k_dx(K.detach().cpu(), dX.cpu(), Kc.detach(), dXc)
    X = _paths(cuda_device, 200, 16, 8)                   # C = 8: JAX's block, not K1's
    before = _launches()
    K = SignatureKernel(0, 4.0).gram_sym(X)
    torch.cuda.synchronize()
    assert _delta(before) == {"block_gram": 1}
    assert not K.requires_grad
    torch.testing.assert_close(K, kb.block_gram_plain(X, 4.0), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C,scale", [(64, 41, 4, 1.0)])
def test_lambda0_gram_and_grad_outside_k1_runs_k7(cuda_device, n, L, C, scale):
    """An L·C > 128 shape (outside both block envelopes): K7's forward and
    backward once each, no K1, and the result the CPU's (the twins)."""
    X = _paths(cuda_device, n, L, C) * scale
    before = _launches()
    K, dX = SignatureKernel(0, 4.0).gram_and_grad(X)
    torch.cuda.synchronize()
    assert _delta(before) == {"small_forward": 1, "small_backward": 1}
    _assert_k_dx(K.cpu(), dX.cpu(), *SignatureKernel(0, 4.0).gram_and_grad(X.cpu()))


def _assert_route_result(kern, X, K, dX, monkeypatch):
    """A route's card result against the same route with the twins in the
    kernels' place: at λ=0 on the CPU, K atol 3e-5 and dX scaled 5e-5; at
    λ=3 on the card (the CPU's and the card's exp move a 33-node λ=3
    sweep's fp32 K by ~1.5e-4), K atol 1e-4 against the fp32 route and dX
    scaled 4e-4 against the route in fp64 (the fp32 twin's own dX may sit
    ~4e-4 from it)."""
    if kern.dyadic_order == 0:
        _assert_k_dx(K.cpu(), dX.cpu(), *kern.gram_and_grad(X.cpu()))
        return
    monkeypatch.setattr(sk, "block3_gram_and_grad", kb3.block3_gram_and_grad_plain)
    monkeypatch.setattr(kf, "fused_forward", kf.fused_forward_plain)
    monkeypatch.setattr(kf, "fused_backward",
                        lambda xt, yt, ck, rc, g: kf.fused_backward_plain(xt, yt, g))
    Kp = kern.gram_and_grad(X)[0]
    dX64 = kern.gram_and_grad(X.double())[1]
    monkeypatch.undo()
    _assert_k_dx(K, dX.double(), Kp, dX64, 1e-4, 4e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 3])
def test_gram_and_grad_on_planner_knots_runs_the_block_kernel(cuda_device, order, monkeypatch):
    """Bench's planning knots at depth 0 and 3 ([1024, 3, 7], inside the
    JAX package's block envelopes; uniform joint-limit-like draws at h =
    1.5): one K1 (K2) launch, no pair-list kernel, and the result the CPU's
    (the twin) at K1's (K2's) tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(order)
    X = (torch.rand((1024, 3, 7), generator=g, device=cuda_device) * 5.0 - 2.5).contiguous()
    kern = SignatureKernel(order, 1.5)
    before = _launches()
    K, dX = kern.gram_and_grad(X)
    torch.cuda.synchronize()
    name = "block_gram_and_grad" if order == 0 else "block3_gram_and_grad"
    assert _delta(before) == {name: 1}
    _assert_route_result(kern, X, K, dX, monkeypatch)


@pytest.mark.cuda
def test_lambda3_gram_and_grad_beyond_the_block_envelope_runs_k4(cuda_device, monkeypatch):
    """λ=3 at [64, 33, 4] (L·C = 132 > 128, ly1 = 32 ≤ 48): the pair list's
    K4 forward and backward once each, no K2, and the result the same
    route's with the twins on the card, at K4's tolerance."""
    X = _paths(cuda_device, 64, 33, 4)
    kern = SignatureKernel(3, 4.0)
    before = _launches()
    K, dX = kern.gram_and_grad(X)
    torch.cuda.synchronize()
    assert _delta(before) == {"fused_forward": 1, "fused_backward": 1}
    _assert_route_result(kern, X, K, dX, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 17, 8), (8, 33, 4), (8, 65, 2), (8, 5, 9)])
def test_block_kernels_raise_just_past_their_envelope(cuda_device, shape):
    """One node (or channel) past K1's and K2's envelope each wrapper raises
    ``NotImplementedError`` naming the route that takes the shape; nothing
    launches."""
    X = torch.zeros(shape, device=cuda_device)
    before = _launches()
    with pytest.raises(NotImplementedError, match="K7"):
        kb.block_gram_and_grad(X, 4.0)
    with pytest.raises(NotImplementedError, match="K4"):
        kb3.block3_gram_and_grad(X, 4.0)
    assert _delta(before) == {}


@pytest.mark.cuda
def test_k7_raises_outside_its_envelope(cuda_device):
    with pytest.raises(NotImplementedError, match="wavefront"):  # ly = 65
        ks.small_forward(torch.zeros(5, 2, 4, device=cuda_device),
                         torch.zeros(65, 2, 4, device=cuda_device), residuals=False)
    with pytest.raises(NotImplementedError, match="wavefront"):  # C = 9
        ks.small_forward(torch.zeros(5, 9, 4, device=cuda_device),
                         torch.zeros(5, 9, 4, device=cuda_device), residuals=False)
    with pytest.raises(NotImplementedError, match="K7"):       # L·C = 136
        kb.block_gram(torch.zeros(8, 17, 8, device=cuda_device), 4.0)
    with pytest.raises(NotImplementedError, match="K7"):       # C = 9
        kb.block_gram(torch.zeros(8, 5, 9, device=cuda_device), 4.0)


def _increments(device, b, lx1, ly1, scale=0.3, seed=0):
    """``[lx1, ly1, b]`` pair-minor increments ``inc/64`` of normal draws
    (the JAX tests' inputs) and a cotangent."""
    g = torch.Generator(device=device).manual_seed(seed)
    inc = torch.randn((lx1, ly1, b), generator=g, device=device) * scale
    return (inc / 64.0).contiguous(), torch.randn(b, generator=g, device=device)


def _assert_k5(z, gout, k_rtol=2e-5, dz_atol=5e-4, chunk=4096):
    """K5's forward (values only and with checkpoints) and backward against
    the fp32 twin, ``chunk`` pairs of the twin at a time."""
    lx1, ly1, P = z.shape
    k, ck = kt.tiled_forward(z, with_ck=True)
    (k_values_only,) = kt.tiled_forward(z, with_ck=False)
    dz = kt.tiled_backward(z, ck, gout)
    torch.cuda.synchronize()
    torch.testing.assert_close(k_values_only, k, atol=0, rtol=0)
    assert torch.isfinite(k).all() and torch.isfinite(dz).all()
    for c0 in range(0, P, chunk):
        sl = slice(c0, c0 + chunk)
        kp, ckp = kt.tiled_forward_plain(z[..., sl], with_ck=True)
        dzp = kt.tiled_backward_plain(z[..., sl], ckp, gout[sl])
        torch.testing.assert_close(k[sl], kp, rtol=k_rtol, atol=1e-6)
        held = torch.arange(c0, min(c0 + chunk, P), device=z.device)
        torch.testing.assert_close(kt.twin_checkpoints(ck, lx1, ly1, P, held), ckp,
                                   rtol=k_rtol, atol=1e-6)
        scale = dzp.abs().max()
        torch.testing.assert_close(dz[..., sl] / scale, dzp / scale, atol=dz_atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lx1,ly1,scale", [
    (5, 3, 3, 0.3), (4, 3, 5, 0.3), (3, 5, 5, 0.3), (2, 2, 5, 0.3), (2561, 3, 3, 0.3),
    (3, 40, 40, 0.05), (300, 6, 48, 0.3), (200, 39, 17, 0.3), (64, 1, 1, 0.3),
    (1500, 7, 9, 0.3), (700, 1, 48, 0.3), (1100, 13, 39, 0.3)])
def test_k5_matches_plain_twin_on_the_card(cuda_device, b, lx1, ly1, scale):
    z, gout = _increments(cuda_device, b, lx1, ly1, scale)
    before = (kt.tiled_forward.launches, kt.tiled_backward.launches)
    tol = dict(k_rtol=1e-4, dz_atol=1e-3) if lx1 == 40 else {}
    _assert_k5(z, gout, **tol)
    assert (kt.tiled_forward.launches, kt.tiled_backward.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_k5_solves_every_pass_of_its_persistent_loop(cuda_device):
    """More tiles than the card holds blocks of the backward at once, so its
    blocks run in three waves, the last a partial tile; every pair is held
    against the twin."""
    resident = kt.resident_blocks(4)[1] * torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    P = 2 * resident * kt.tiled_plan(1, 5, 4).pairs_per_tile + 37
    assert kt.tiled_plan(P, 5, 4).tiles > 2 * resident
    z, gout = _increments(cuda_device, P, 5, 4, seed=5)
    _assert_k5(z, gout, chunk=65536)


@pytest.mark.cuda
def test_k5_raises_outside_its_envelope(cuda_device):
    with pytest.raises(NotImplementedError, match="wavefront"):  # ly1 = 49
        kt.tiled_forward(torch.zeros(5, 49, 4, device=cuda_device), with_ck=False)
    # beyond ly1 = 48 the linear kernel takes the wavefront, on the card as
    # on the CPU
    kern = SignatureKernel(3, static="linear")
    X = _paths(cuda_device, 4, 50, 2)
    K, dX = kern.gram_and_grad(X)
    _assert_k_dx(K.cpu(), dX.cpu(), *kern.gram_and_grad(X.cpu()), k_atol=1e-4)
    with pytest.raises(ValueError, match="checkpoints"):
        kt.tiled_backward(torch.zeros(5, 4, 8, device=cuda_device),
                          torch.zeros(2, 33, 8, device=cuda_device),  # the twin's layout
                          torch.zeros(8, device=cuda_device))


def _k5_launches():
    return {f.__name__: f.launches for f in (
        kt.tiled_forward, kt.tiled_backward, kf.fused_forward, kf.fused_backward,
        kf.fused_backward_bf16, kb3.block3_gram_and_grad)}


@pytest.mark.cuda
def test_k5_routes_launch_it_and_match_the_cpu(cuda_device, monkeypatch):
    """The routes that take K5, each against the same route on the CPU (K5's
    twin): linear ``gram_and_grad`` (one forward, one backward, no K2 or
    K4), the dense linear ``gram`` with its gradient (one and one), the
    linear ``gram_sym`` and the streamed linear ``gram`` with their
    gradients (a checkpointed chunk: two forwards, one backward), and
    C = 12 ``gram_and_grad``; K atol 1e-4, dX scaled 5e-4."""
    X, Y = _paths(cuda_device, 24, 40, 2) * 4.0, _paths(cuda_device, 17, 33, 2, 1) * 4.0
    Z = _paths(cuda_device, 16, 17, 12)
    lin = SignatureKernel(3, static="linear")

    def grad_run(fn, dev, *args):
        x = X.to(dev, copy=True).requires_grad_(True)
        K = fn(x, *[a.to(dev) for a in args])
        (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach().cpu(), dX.cpu()

    cases = (("gram_and_grad", lambda: lin.gram_and_grad(X),
              lambda: lin.gram_and_grad(X.cpu()), {"tiled_forward": 1, "tiled_backward": 1}),
             ("dense_gram", lambda: grad_run(lin.gram, cuda_device, Y),
              lambda: grad_run(lin.gram, "cpu", Y), {"tiled_forward": 1, "tiled_backward": 1}),
             ("gram_sym", lambda: grad_run(lin.gram_sym, cuda_device),
              lambda: grad_run(lin.gram_sym, "cpu"), {"tiled_forward": 2, "tiled_backward": 1}),
             ("c12", lambda: SignatureKernel(3, 4.0).gram_and_grad(Z),
              lambda: SignatureKernel(3, 4.0).gram_and_grad(Z.cpu()),
              {"tiled_forward": 1, "tiled_backward": 1}))
    for name, card, cpu, want in cases:
        before = _k5_launches()
        K, dX = card()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _k5_launches().items() if v != before[k]}
        assert got == want, (name, got)
        _assert_k_dx(K.cpu(), dX.cpu(), *cpu(), k_atol=1e-4, dx_atol=5e-4)
    monkeypatch.setattr(SignatureKernel, "_DENSE_LIMIT", 1000)
    before = _k5_launches()
    K, dX = grad_run(lin.gram, cuda_device, Y)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _k5_launches().items() if v != before[k]}
    assert got == {"tiled_forward": 2, "tiled_backward": 1}, got
    _assert_k_dx(K, dX, *grad_run(lin.gram, "cpu", Y), k_atol=1e-4, dx_atol=5e-4)


def _mc_first_step(dev, pol, eps):
    """The MC solve of 2 steps on ``dev`` with the given draws: its K1
    launches, its data and the first step's score and Stein velocity."""
    import dataclasses

    from sigsvgd_tpu_torch.controllers.dust import DuStDraws
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    n, H = pol.shape[:2]
    prob = build_arm_mpc(device=dev, n_pol=n, hz_len=H, dyadic_order=0, calibrate=False)
    ctrl = dataclasses.replace(prob.ctrl, n_action_samples=eps.shape[1])
    cs = ctrl.init(pol_mean=pol.to(dev))
    before = kb.block_gram_and_grad.launches
    _a, _cs, data = ctrl.forward(prob.q_start, cs, opt_steps=eps.shape[0],
                                 draws=DuStDraws(actions=eps.to(dev)))
    launches = kb.block_gram_and_grad.launches - before
    prior = ParticleGMM(cs.pol_mean.reshape(n, -1), ctrl._prior_var(), cs.prior_weights)
    score, _ = ctrl._score(cs.pol_mean, prob.q_start, prior, None, eps[0].to(dev))
    phi, _ = ctrl._sampler().velocity(cs.pol_mean, score, 0)
    return launches, data, score, phi


@pytest.mark.cuda
def test_mc_solve_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(8)
    pol = torch.rand((16, 8, 7), generator=gen) * 4.0 - 2.0
    eps = torch.randn((2, 4, 16, 8, 7), generator=gen)
    n_card, d_card, s_card, phi_card = _mc_first_step(cuda_device, pol, eps)
    n_cpu, d_cpu, s_cpu, phi_cpu = _mc_first_step("cpu", pol, eps)
    assert (n_card, n_cpu) == (2, 0)
    assert tuple(d_card.costs.shape) == (2, 4, 16)
    torch.testing.assert_close(d_card.costs[0].cpu(), d_cpu.costs[0], rtol=1e-5, atol=0)
    _assert_k_dx(s_card.k_xx.cpu(), s_card.grad_k.cpu(), s_cpu.k_xx, s_cpu.grad_k)
    scale = phi_cpu.abs().max()
    torch.testing.assert_close(phi_card.cpu() / scale, phi_cpu / scale, atol=1e-4, rtol=0)
    assert int(torch.argmax(d_card.pol_weights)) == int(torch.argmax(d_cpu.pol_weights))


@pytest.mark.cuda
@pytest.mark.parametrize("lam,shape,chunk", [(0, (9, 5, 7), None), (1, (600, 12, 20), 256),
                                             (2, (33, 39, 39), None)])
def test_wavefront_matches_cpu(cuda_device, lam, shape, chunk):
    """The wavefront (torch ops, no kernel of its own) on the card against
    the CPU on the same increments, in chunks as asked: k rtol 1e-6 / atol
    1e-6 (both fuse each node into one multiply-add) and the adjoint scaled
    by its max at 1e-5 (the card's scatter-add sums in another order)."""
    from sigsvgd_tpu_torch.kernels.sigkernel import solve_goursat_pde

    g = torch.Generator().manual_seed(lam)
    inc = torch.randn(shape, generator=g) * 0.2
    gout = torch.randn(shape[0], generator=g)
    out = []
    for dev in (cuda_device, "cpu"):
        x = inc.to(dev).requires_grad_(True)
        k = solve_goursat_pde(x, lam, chunk)
        (d,) = torch.autograd.grad(k, x, gout.to(dev))
        out.append((k.detach().cpu(), d.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=1e-6)
    scale = out[1][1].abs().max()
    torch.testing.assert_close(out[0][1] / scale, out[1][1] / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(kernel_mode="trajectory"),
                                dict(kernel_mode="policy", stein_sampler="MatrixSVGD",
                                     scaled=True)],
                         ids=["trajectory", "matrix_policy"])
def test_trajectory_and_matrix_solves_match_cpu(cuda_device, kw):
    """The trajectory kernel mode and MatrixSVGD (``ScaledGaussianKernel``)
    on 16 policies, H = 8, on the card and the CPU from the same policies:
    the first step's costs rtol 1e-5, the trajectory K rtol 1e-5 and its
    gradient scaled 1e-4, φ scaled 1e-4, the weights' argmax."""
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.kernels.rbf import ScaledGaussianKernel
    from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

    kw = dict(kw)
    kernel = ScaledGaussianKernel() if kw.pop("scaled", False) else None
    pol = torch.rand((16, 8, 7), generator=torch.Generator().manual_seed(9)) * 4.0 - 2.0
    res = []
    for dev in (cuda_device, "cpu"):
        prob = build_arm_mpc(device=dev, n_pol=16, hz_len=8, kernel=kernel, **kw)
        ctrl = prob.ctrl
        cs = ctrl.init(pol_mean=pol.to(dev))
        prior = ParticleGMM(cs.pol_mean.reshape(16, -1), ctrl._prior_var(), cs.prior_weights)
        score, _ = ctrl._score(cs.pol_mean, prob.q_start, prior)
        phi, _ = ctrl._sampler().velocity(cs.pol_mean, score, 0)
        _a, _cs, data = ctrl.forward(prob.q_start, cs, opt_steps=2)
        res.append((score, phi, data))
    (s_card, phi_card, d_card), (s_cpu, phi_cpu, d_cpu) = res
    torch.testing.assert_close(s_card.aux["costs"].cpu(), s_cpu.aux["costs"], rtol=1e-5,
                               atol=0)
    if kw["kernel_mode"] == "trajectory":
        torch.testing.assert_close(s_card.k_xx.cpu(), s_cpu.k_xx, rtol=1e-5, atol=1e-6)
        scale = s_cpu.grad_k.abs().max()
        torch.testing.assert_close(s_card.grad_k.cpu() / scale, s_cpu.grad_k / scale,
                                   rtol=0, atol=1e-4)
    scale = phi_cpu.abs().max()
    torch.testing.assert_close(phi_card.cpu() / scale, phi_cpu / scale, atol=1e-4, rtol=0)
    assert int(torch.argmax(d_card.pol_weights)) == int(torch.argmax(d_cpu.pol_weights))


def _uniform_knots(device, n, seed):
    """Knots ``[n, 3, 7]`` as ``run_optimisation`` draws them."""
    from sigsvgd_tpu_torch.experiments.planning import uniform_knots
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

    g = torch.Generator(device=device).manual_seed(seed)
    return uniform_knots(PandaRobot.create(device=device), n, 3, g)


@pytest.mark.cuda
def test_k4_at_the_sweep_shape(cuda_device):
    """K4 at the quick sweep's pathsig Gram, the triangle of knots [8, 3, 7]
    at h = 1.5: k atol 1e-4 against the fp32 twin, both tiles' gradients
    scaled 4e-4 against the twin in fp64 (K4's tolerances)."""
    iu, ju = torch.triu_indices(8, 8, device=cuda_device)
    xt, yt = kb3._pair_tiles(_uniform_knots(cuda_device, 8, 1), 1.5, iu, ju)
    g = torch.where(iu == ju, 1.0, 2.0)
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)
    dx, dy = kf.fused_backward(xt, yt, ck, rc, g)
    kp, _, _ = kf.fused_pairs_plain(xt, yt, g)
    _, dx64, dy64 = kf.fused_pairs_plain(xt.double(), yt.double(), g.double())
    torch.testing.assert_close(k, kp, atol=1e-4, rtol=0)
    for got, want in ((dx, dx64), (dy, dy64)):
        scale = want.abs().max()
        torch.testing.assert_close(got.double() / scale, want / scale, atol=4e-4, rtol=0)


@pytest.mark.cuda
def test_k2_at_the_field_shape(cuda_device):
    """K2 at the obstacle field's pathsig Gram, knots [16, 4, 2] uniform in
    [-4, 4]² at h = 3.0: K atol 1e-4 against the fp32 twin, dX scaled 4e-4
    against the twin in fp64 (K2's tolerances)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    X = -4.0 + 8.0 * torch.rand((16, 4, 2), generator=g, device=cuda_device)
    K, dX = kb3.block3_gram_and_grad(X, 3.0)
    Kp, _ = kb3.block3_gram_and_grad_plain(X, 3.0)
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 3.0)
    torch.testing.assert_close(K, Kp, atol=1e-4, rtol=0)
    scale = dX64.abs().max()
    torch.testing.assert_close(dX.double() / scale, dX64 / scale, atol=4e-4, rtol=0)


def _planning_launches():
    fns = (kf.fused_forward, kf.fused_backward, kb3.block3_gram_and_grad, mc.mxu_chain_fwd,
           mc.mxu_chain_bwd)
    return {f.__name__: f.launches for f in fns}


def _grown(before):
    return {k: v - before[k] for k, v in _planning_launches().items()}


@pytest.mark.cuda
def test_sweep_cell_matches_cpu(cuda_device):
    """A quick sweep cell (``pillars_4``'s first request, pathsig at depth 3
    on knots [4, 3, 7], T = 20, 3 iterations) on the card and on the CPU
    from the same knots: the requests equal, the knots and losses rtol 1e-4,
    atol 1e-5 (the chained planning runs' tolerance); K2 once an iteration
    on the card (the knots are inside its envelope), no other kernel."""
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig, run_optimisation
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

    cfg = PlannerConfig(n_iter=3, batch=4, depth=3, timesteps=20)
    u = torch.rand((4, 3, 7), generator=torch.Generator().manual_seed(3))
    out = {}
    for dev in (cuda_device, "cpu"):
        robot = PandaRobot.create(device=dev)
        lower, upper = robot.joint_limits()
        reqs = rp.default_requests(robot, "pillars_4", n=1)
        problem = rp.build_problem(robot, "pillars_4", reqs[0], False, None, None,
                                   cfg.timesteps)
        before = _planning_launches()
        x, data = run_optimisation(problem, cfg, x0=lower + (upper - lower) * u.to(dev))
        out[dev] = ([(r.start, r.target) for r in reqs], x.cpu(), data.loss.cpu(),
                    _grown(before))
    (rg, xg, lg, cg), (rc, xc, lc, cc) = out[cuda_device], out["cpu"]
    assert rg == rc
    torch.testing.assert_close(xg, xc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)
    assert cg == dict.fromkeys(cg, 0) | {"block3_gram_and_grad": 3}
    assert cc == dict.fromkeys(cc, 0)


@pytest.mark.cuda
def test_learned_cost_gradient_matches_cpu(cuda_device):
    """The planning cost with a learned occupancy and self-collision model
    (random numpy weights in flax's layout through
    ``prob_model_from_numpy``) and its gradient in the knots, on the card
    and on the CPU: the cost rtol 1e-5, the gradient scaled atol 1e-4 (the
    planning cost's gradient tolerance, ``tests/test_torch_planning.py``)."""
    from sigsvgd_tpu_torch.convert import prob_model_from_numpy
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.inference.score import _grad_neg_cost
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot
    from sigsvgd_tpu_torch.models.robot.scene import PathRequest

    rng = np.random.default_rng(5)

    def params(in_dim, feats):
        widths = (in_dim,) + feats + (1,)
        return {f"Dense_{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32)
                               / np.sqrt(a), "bias": 0.1 * rng.standard_normal(b).astype(
                                   np.float32)}
                for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}

    occ_p, self_p = params(3, (64, 64)), params(7, (64, 64))
    req = PathRequest((0.0, -0.6, 0.0, -2.0, 0.0, 1.5, 0.0), (1.2, -0.3, 0.3, -1.5, 0.2, 1.8, 0.5))
    x = _uniform_knots("cpu", 6, 6)
    res = []
    for dev in (cuda_device, "cpu"):
        robot = PandaRobot.create(device=dev)
        problem = rp.build_problem(robot, "pillars_4", req, True,
                                   prob_model_from_numpy(occ_p, (64, 64), device=dev),
                                   prob_model_from_numpy(self_p, (64, 64), device=dev), 50)
        cost, _, g = _grad_neg_cost(problem.batch_cost, x.to(dev))
        res.append((cost.cpu(), g.cpu()))
    (cg, gg), (cc, gc) = res
    torch.testing.assert_close(cg, cc, rtol=1e-5, atol=0)
    scale = gc.abs().max()
    torch.testing.assert_close(gg / scale, gc / scale, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_planning_paths_launch_their_kernels(cuda_device):
    """The launch counts of the new paths: a quick sweep's pathsig cell
    (``run_experiment`` at depth 3 on knots [8, 3, 7], 2 iterations: 2 K2),
    the obstacle field's pathsig run (3 iterations: 3 K2) and a
    ``PlannerConfig()``-depth cell (order 6, ``mxu_precision="default"``, 2
    iterations: 2 K8 forward and 2 backward); no other kernel."""
    from sigsvgd_tpu_torch.experiments import obstacle_field as of
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.experiments.planning import PlannerConfig

    zero = dict.fromkeys(_planning_launches(), 0)
    before = _planning_launches()
    rows = rp.run_experiment(["pillars_4"], ["pathsig"], 1, None,
                             PlannerConfig(n_iter=2, batch=8, depth=3, timesteps=20),
                             n_requests=1)
    assert len(rows) == 1 and np.isfinite(rows[0]["best_ee_length"])
    assert _grown(before) == zero | {"block3_gram_and_grad": 2}
    before = _planning_launches()
    res = of.run(method="pathsig", n_iter=3)
    assert np.isfinite(res["final_costs"]).all()
    assert _grown(before) == zero | {"block3_gram_and_grad": 3}
    before = _planning_launches()
    rp.run_experiment(["pillars_4"], ["pathsig"], 1, None,
                      PlannerConfig(n_iter=2, timesteps=20), n_requests=1)
    assert _grown(before) == zero | {"mxu_chain_fwd": 2, "mxu_chain_bwd": 2}


def _lbfgs_case(device, seed=0):
    """A badly scaled target whose line searches grow and zoom, with a
    direction off its gradient (as the Stein velocity is)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((6, 6), generator=g)
    A = ((A @ A.T / 6 + torch.eye(6)) * 8.0).to(device)

    def f(x):
        v = x.reshape(-1)
        return 0.5 * v @ A @ v + 3.0 * torch.cos(2.0 * x).sum()

    def direction(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (gr,) = torch.autograd.grad(f(xx), xx)
        return gr * 1.3 + 0.1

    return f, direction, (torch.randn((3, 2), generator=g) * 2.0).to(device)


@pytest.mark.cuda
def test_lbfgs_updates_match_cpu(cuda_device):
    """L-BFGS with the zoom line search on the card against the CPU, one
    update at a time from the same state: every leaf within rtol 1e-5 /
    atol 1e-6 (``tests/test_torch_lbfgs.py``'s tolerance against optax), the
    probe counts equal."""
    from sigsvgd_tpu_torch.inference.svgd import lbfgs

    opt = lbfgs(memory_size=4)
    f_c, dir_c, x = _lbfgs_case("cpu")
    f_g, dir_g, _ = _lbfgs_case(cuda_device)
    state = opt.init(x)
    probes = []
    for _ in range(8):
        u_c, s_c = opt.update(dir_c(x), state, x, value=f_c(x), value_fn=f_c)
        moved = [t.to(cuda_device) if isinstance(t, torch.Tensor) else t
                 for t in (x, *_leaves(state))]
        s_g_in = _unflatten(state, moved[1:])
        xg = moved[0]
        u_g, s_g = opt.update(dir_g(xg), s_g_in, xg, value=f_g(xg), value_fn=f_g)
        assert int(s_g[2].info.num_linesearch_steps) == int(s_c[2].info.num_linesearch_steps)
        for a, b in zip(_leaves(s_g), _leaves(s_c)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(u_g.cpu(), u_c, rtol=1e-5, atol=1e-6)
        probes.append(int(s_c[2].info.num_linesearch_steps))
        x, state = x + u_c, s_c
    assert max(probes) > 1, probes


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def _unflatten(template, leaves):
    it = iter(leaves)

    def fill(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(fill(c) for c in node))
        if isinstance(node, tuple):
            return tuple(fill(c) for c in node)
        return next(it)

    return fill(template)


@pytest.mark.cuda
def test_checkpoints_round_trip_card_tensors_and_generator(cuda_device, tmp_path):
    """CUDA tensors come back on the card with their dtypes; a CUDA
    generator's restored state repeats its draws."""
    from sigsvgd_tpu_torch.inference.svgd import lbfgs
    from sigsvgd_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    torch.rand(5, generator=gen, device=cuda_device)
    x = torch.randn((4, 3, 2), generator=gen, device=cuda_device)
    tree = {"x": x, "opt": lbfgs(memory_size=3).init(x), "gen": gen.get_state()}
    save_checkpoint(tmp_path / "step_1", tree)
    want = torch.rand(7, generator=gen, device=cuda_device)
    back = restore_checkpoint(tmp_path / "step_1", tree)
    assert back["x"].device.type == "cuda" and torch.equal(back["x"], x)
    assert back["opt"][0].count.dtype == torch.int32 and back["opt"][0].count.is_cuda
    gen2 = torch.Generator(device=cuda_device)
    gen2.set_state(back["gen"])
    assert torch.equal(torch.rand(7, generator=gen2, device=cuda_device), want)


@pytest.mark.cuda
def test_grid_sdf_matches_cpu(cuda_device, tmp_path):
    """A closed box mesh's grid lookup on the card against the CPU: values
    and gradients within 1e-6, inside, outside and beyond the lattice."""
    from sigsvgd_tpu_torch.models.robot import mesh_scene as ms

    stl = tmp_path / "box.stl"
    ms.write_stl(stl, ms.box_mesh((0.3, 0.2, 0.4)))
    grid = ms.mesh_sdf_grid(ms.MeshObstacle(str(stl), position=(0.1, 0.0, 0.5)),
                            (-0.6, -0.6, 0.0), (0.6, 0.6, 1.2))
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((20000, 3), generator=g) * torch.tensor([1.6, 1.6, 1.6]) - torch.tensor(
        [0.8, 0.8, 0.2])
    res = []
    for dev in (cuda_device, "cpu"):
        x = pts.to(dev).requires_grad_(True)
        v = ms.grid_sdf(grid, x)
        (dx,) = torch.autograd.grad(v.sum(), x)
        res.append((v.detach().cpu(), dx.cpu()))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(res[0][1], res[1][1], rtol=1e-6, atol=1e-6)
    assert (res[1][0] < 0).any() and len(grid._on_device) == 2


@pytest.mark.cuda
def test_toy_targets_match_cpu(cuda_device):
    """The toy targets on the card against the CPU in fp64 (the star's
    1/100 variance amplifies fp32 rounding to ~3e-4 in its score): ``logp``,
    the score and the banana's Hessian within rtol 1e-6 / atol 1e-6, the
    fp32 star built on the card equal to the CPU's within 1e-6."""
    from sigsvgd_tpu_torch.models import toy

    x = torch.rand((256, 2), generator=torch.Generator().manual_seed(1),
                   dtype=torch.float64) * 4.0 - 2.0
    star32_c, star32_g = toy.star_gaussian(device="cpu"), toy.star_gaussian()
    torch.testing.assert_close(star32_g.sigmas.cpu(), star32_c.sigmas, rtol=1e-6, atol=1e-6)
    star_c = toy.StarGaussian(star32_c.mus.double(), star32_c.sigmas.double())
    star_g = toy.StarGaussian(star_c.mus.to(cuda_device), star_c.sigmas.to(cuda_device))
    for tgt_c, tgt_g in ((toy.DoubleBanana(),) * 2, (toy.Sine(),) * 2, (star_c, star_g)):
        for fn in ("logp", "grad_log_p", "hessian_log_p"):
            if not hasattr(tgt_c, fn):
                continue
            got = getattr(tgt_g, fn)(x.to(cuda_device)).cpu()
            torch.testing.assert_close(got, getattr(tgt_c, fn)(x), rtol=1e-6, atol=1e-6)
    s = star32_g.sample(1000, torch.Generator(device=cuda_device).manual_seed(0))
    assert s.is_cuda and s.shape == (1000, 2)


@pytest.mark.cuda
def test_moveit_scene_loads_onto_the_card(cuda_device, tmp_path):
    """The MoveIt importer onto the card; PyYAML is not on every machine
    with a card, and the test skips without it."""
    yaml = pytest.importorskip("yaml")
    from sigsvgd_tpu_torch.models.robot import robodata
    from sigsvgd_tpu_torch.models.robot.scene import scene_sdf

    doc = {"world": {"collision_objects": [{
        "id": "ball", "pose": {"position": [0.0, 0.0, 0.0], "orientation": [0, 0, 0, 1]},
        "primitives": [{"type": "sphere", "dimensions": [0.1]}],
        "primitive_poses": [{"position": [-0.4, 0.2, 0.5], "orientation": [0, 0, 0, 1]}]}]}}
    path = tmp_path / "s.yaml"
    path.write_text(yaml.safe_dump(doc))
    scene = robodata.load_moveit_scene(path)
    d = scene_sdf(scene, torch.tensor([[-0.4, 0.2, 0.5]], device=scene.device))
    assert scene.device.type == "cuda" and float(d[0]) < 0


@pytest.mark.cuda
def test_gym_pendulum_runs_on_the_card(cuda_device):
    """A short DuSt swing-up against gymnasium with the controller on the
    card; gymnasium is not on every machine with a card, and the test skips
    without it."""
    pytest.importorskip("gymnasium")
    from sigsvgd_tpu_torch.controllers.dust import DuSt
    from sigsvgd_tpu_torch.experiments import gym_sim
    from sigsvgd_tpu_torch.inference.svgd import Adam

    model = gym_sim.gym_pendulum_model()
    ctrl = DuSt(model=model, hz_len=20, n_pol=16, kernel_mode="policy", optimizer=Adam(0.3),
                inst_cost_fn=model.swingup_inst_cost, term_cost_fn=model.swingup_term_cost)
    cstate = ctrl.init(generator=torch.Generator(device=cuda_device).manual_seed(0))
    out = gym_sim.run_gym_pendulum(ctrl, cstate, n_steps=10, opt_steps=3)
    assert np.isfinite(out["states"]).all() and out["actions"].shape == (10, 1)


@pytest.mark.cuda
def test_planning_cost_gradient_is_bitwise_repeatable(cuda_device):
    """The planning cost, its gradient and the order-6 signature kernel's
    gradient (K8) repeat bit for bit on the card at ``PlannerConfig()``'s
    width on ``pillars_4`` (the splines gather by a one-hot product, whose
    backward has no atomics), so an L-BFGS planning run resumed from a
    checkpoint repeats the uninterrupted one. A failure names the check and
    its largest difference."""
    from sigsvgd_tpu_torch.experiments import robot_planning as rp
    from sigsvgd_tpu_torch.inference.score import _grad_neg_cost
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

    robot = PandaRobot.create(device=cuda_device)
    req = rp.default_requests(robot, "pillars_4", n=1)[0]
    problem = rp.build_problem(robot, "pillars_4", req, False, None, None, 200)
    x = _uniform_knots(cuda_device, 20, 3)
    kern = SignatureKernel(6, 1.5, mxu_precision="default")

    def checks():
        with torch.no_grad():
            cost = problem.batch_cost(x)[0]
        return {"cost": cost, "cost gradient": _grad_neg_cost(problem.batch_cost, x)[2],
                "K8 gradient": kern.gram_and_grad(x)[1]}

    first = checks()
    for _ in range(3):
        for name, got in checks().items():
            diff = (got - first[name]).abs().max().item()
            assert torch.equal(got, first[name]), f"{name}: max |diff| {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [2, 3])
@pytest.mark.parametrize("which,n", [("k1", 333), ("k1", 1024), ("k2", 77), ("k2", 130)])
def test_tile_subsets_match_their_subset_twins(cuda_device, which, n, ndev):
    """K1 and K2 over one rank's tiles of ``tile_shard`` against their twins
    on that rank's pairs (``tile_pairs``): K1's K bit for bit and K2's at
    atol 1e-4, zero off the subset's pairs (the kernels write no other slot
    of K, which starts at zero); dX at each kernel's tolerance (K2's against
    the twin in fp64). Summed over the ranks, K and dX are the whole
    launch's; the reduction reads only the subset's partial slots, so slots
    left over from an earlier launch change nothing (each launch's partials
    are fresh ``torch.empty`` memory)."""
    L, C = (40, 2)
    X = _paths(cuda_device, n, L, C, seed=ndev)
    fn = kb.block_gram_and_grad if which == "k1" else kb3.block3_gram_and_grad
    tc = kb.THREADS // kb.block_lanes(L)[0]
    tiles = kb._tile_list(n, tc, cuda_device)
    K_all, dX_all = fn(X, 4.0)
    K_sum, dX_sum = torch.zeros_like(K_all), torch.zeros_like(dX_all)
    for r in range(ndev):
        before = fn.launches
        K, dX = fn(X, 4.0, shard=(ndev, r))
        assert fn.launches == before + 1
        pairs = kb.tile_pairs(kb.tile_shard(tiles, ndev, r), n, tc)
        if which == "k1":
            Kp, dXp = kb.block_gram_and_grad_plain(X, 4.0, pairs=pairs)
            assert torch.equal(K, Kp)
            _assert_k_dx(K.cpu(), dX.cpu(), Kp.cpu(), dXp.cpu())
        else:
            Kp, _ = kb3.block3_gram_and_grad_plain(X, 4.0, pairs_per_chunk=4096, pairs=pairs)
            _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 4.0, pairs_per_chunk=4096,
                                                     pairs=pairs)
            _assert_k_dx(K.cpu(), dX.double().cpu(), Kp.cpu(), dX64.cpu(), 1e-4, 4e-4)
        off = torch.ones_like(K, dtype=torch.bool)
        off[pairs[0], pairs[1]] = False
        off[pairs[1], pairs[0]] = False
        assert not K[off].any()
        K_sum += K
        dX_sum += dX
    torch.testing.assert_close(K_sum, K_all, atol=0, rtol=0)
    scale = dX_all.abs().max()
    torch.testing.assert_close(dX_sum / scale, dX_all / scale, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_k8_on_a_pair_list_chunk_matches_the_twin(cuda_device, monkeypatch):
    """Above the dense guard ``gram_and_grad`` takes the triangle pair list;
    here one chunk of it, with one K8 forward and one backward, against the
    same route on the CPU (K8's twin): K scaled 1e-3, dX scaled 2e-3."""
    monkeypatch.setattr(SignatureKernel, "_DENSE_LIMIT", 100)
    g = torch.Generator().manual_seed(3)
    X = (torch.rand((96, 3, 7), generator=g) * 2.0 - 1.0)
    kern = SignatureKernel(dyadic_order=6, bandwidth=2.0, mxu_precision="default")
    assert kern._chunk_plan(2, 2, 96 * 97 // 2, 7, cuda_device, 2.0)[2] == 1
    f0, b0 = mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches
    K, dX = kern.gram_and_grad(X.to(cuda_device))
    assert (mc.mxu_chain_fwd.launches - f0, mc.mxu_chain_bwd.launches - b0) == (1, 1)
    Kp, dXp = kern.gram_and_grad(X)
    sk, sg = Kp.abs().max(), dXp.abs().max()
    torch.testing.assert_close(K.cpu() / sk, Kp / sk, atol=1e-3, rtol=0)
    torch.testing.assert_close(dX.cpu() / sg, dXp / sg, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_sharded_lambda0_solve_on_two_ranks_sharing_the_card(cuda_device, tmp_path):
    """The sharded triangle solve at λ=0 on a gloo group of 2 ranks sharing
    the card: each rank launches K1 once a step over its tiles, and the
    actions, the policies and Adam's moments match the single-device solve
    on the card at ``tests/test_parallel_dust.py``'s 2e-3 / 2e-4."""
    from _torch_dist_ranks import result, start_ranks

    pol = np.random.default_rng(11).uniform(-2.0, 2.0, (48, 12, 1)).astype(np.float32)
    spec = dict(device="cuda", ctrl=dict(hz_len=12, n_pol=48, kernel_mode="signature",
                                         adam=0.1, sig=dict(dyadic_order=0, bandwidth=4.0)),
                opt_steps=2, modes=["triangle"], state=[float(np.pi), 0.0], pol0=pol)
    out = result(start_ranks(2, [("lambda0", "case_dust", spec)], tmp_path).join(), "lambda0")
    assert out["launches"]["triangle"] == (2, 0)
    for g, w in zip(out["triangle"][0], out["single"][0]):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
