"""Port robot stack against the JAX package: URDF chain, FK, scene SDFs (values
and gradients, including points on box faces where JAX's tie gradients
apply), body points and exact-SDF occupancy. fp32; tolerances per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments.planning import create_body_points as j_body
from sigsvgd_tpu.experiments.planning import sdf_occupancy as j_occ
from sigsvgd_tpu.models.robot import panda as jpanda
from sigsvgd_tpu.models.robot.kinematics import fk_poses as j_fk_poses
from sigsvgd_tpu.models.robot import scene as jscene
from sigsvgd_tpu.models.robot.urdf import parse_urdf as j_parse
from sigsvgd_tpu_torch.experiments.planning import create_body_points, sdf_occupancy
from sigsvgd_tpu_torch.models.robot import scene as tscene
from sigsvgd_tpu_torch.models.robot.kinematics import fk_poses
from sigsvgd_tpu_torch.models.robot.panda import PandaRobot, _find_urdf
from sigsvgd_tpu_torch.models.robot.urdf import parse_urdf


@pytest.fixture(scope="module")
def robots():
    return PandaRobot.create(device="cpu"), jpanda.PandaRobot.create()


def test_urdf_chain_arrays_equal():
    t, j = parse_urdf(_find_urdf(None)), j_parse(_find_urdf(None))
    for f in ("name", "base_link", "joint_names", "child_links", "actuated_names",
              "collision_meshes"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("parent_joint", "origins", "axes", "joint_types", "q_index", "lower",
              "upper", "velocity"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_qs_to_joints_xs_matches(rng, robots):
    tr, jr = robots
    low, high = (np.asarray(v) for v in jr.joint_limits())
    q = rng.uniform(low, high, size=(6, 5, 7)).astype(np.float32)
    got = tr.qs_to_joints_xs(torch.from_numpy(q))
    assert got.shape == (6, 5, 9, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jr.qs_to_joints_xs(jnp.asarray(q))),
                               atol=1e-5)
    tl, th = tr.joint_limits()
    np.testing.assert_array_equal(tl.numpy(), low)
    np.testing.assert_array_equal(th.numpy(), high)


def test_fk_poses_match(rng, robots):
    tr, jr = robots
    q = rng.uniform(-1.5, 1.5, size=(5, tr.chain.dof)).astype(np.float32)
    pt, rt = fk_poses(tr.chain, torch.from_numpy(q))
    pj, rj = j_fk_poses(jr.chain, jnp.asarray(q))
    assert pt.shape == (5, tr.chain.n_joints, 3) and rt.shape == (5, tr.chain.n_joints, 3, 3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)


def test_fk_gradient_matches(rng, robots):
    tr, jr = robots
    q = rng.uniform(-1.5, 1.5, size=(8, 7)).astype(np.float32)
    w = rng.normal(size=(8, 9, 3)).astype(np.float32)
    qt = torch.from_numpy(q).requires_grad_(True)
    (gt,) = torch.autograd.grad((tr.qs_to_joints_xs(qt) * torch.from_numpy(w)).sum(), qt)
    gj = jax.grad(lambda v: jnp.sum(jr.qs_to_joints_xs(v) * w))(jnp.asarray(q))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-5)


def _scene_points(rng, scene):
    pts = [rng.uniform([-0.2, -0.8, -0.1], [1.0, 0.8, 1.5], size=(200, 3))]
    for p in scene.primitives:
        c = np.asarray(p.position)
        if p.kind == "box":
            h = np.asarray(p.size) / 2.0
            # face centres and a corner: abs/relu/max ties of the box SDF
            for ax in range(3):
                for sgn in (-1.0, 1.0):
                    f = c.copy()
                    f[ax] += sgn * h[ax]
                    pts.append(f[None])
            pts.append((c + h)[None])
            pts.append(c[None])
        else:
            pts.append(c[None])
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("tag", tscene.SCENE_TAGS)
def test_scene_sdf_values_and_gradients(rng, tag):
    ts, js = tscene.get_scene(tag, device="cpu"), jscene.get_scene(tag)
    assert [(p.kind, p.position, p.size) for p in ts.primitives] == \
        [(p.kind, p.position, p.size) for p in js.primitives]
    x = _scene_points(rng, ts)
    if not ts.primitives:
        assert torch.isinf(tscene.scene_sdf(ts, torch.from_numpy(x))).all()
        return
    xt = torch.from_numpy(x).requires_grad_(True)
    vt = tscene.scene_sdf(ts, xt)
    (gt,) = torch.autograd.grad(vt.sum(), xt)
    gj = jax.grad(lambda v: jnp.sum(jscene.scene_sdf(js, v)))(jnp.asarray(x))
    vj = np.asarray(jscene.scene_sdf(js, jnp.asarray(x)))
    np.testing.assert_allclose(vt.detach().numpy(), vj, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


def test_body_points_and_occupancy(rng):
    xs = rng.normal(size=(4, 3, 9, 3)).astype(np.float32) * 0.5
    bt = create_body_points(torch.from_numpy(xs), 4)
    bj = np.asarray(j_body(jnp.asarray(xs), 4))
    assert bt.shape == bj.shape == (4, 3, 32, 3)
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-6)

    ts = tscene.get_scene("bookshelf_small", device="cpu")
    js = jscene.get_scene("bookshelf_small")
    pts = rng.uniform([0.2, -0.6, 0.0], [0.8, 0.6, 1.3], size=(500, 3)).astype(np.float32)
    pt = torch.from_numpy(pts).requires_grad_(True)
    ot = sdf_occupancy(ts)(pt)
    (gt,) = torch.autograd.grad(ot.sum(), pt)
    gj = jax.grad(lambda v: jnp.sum(j_occ(js)(v)))(jnp.asarray(pts))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(j_occ(js)(jnp.asarray(pts))),
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, rtol=1e-5)
