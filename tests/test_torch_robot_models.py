"""The models the port's arm-planning sweep builds on, against the JAX
package on the CPU.

M3's rest (``velocity_limits``, ``ee_pose``, the exact Jacobian atol 1e-5
against ``jax.jacfwd``, the damped-least-squares IK after 100 iterations
from JAX's start: ``q`` atol 1e-4 and an end-effector error under 0.01 as
``tests/test_robot.py``), the capsule self-collision oracle (segment
distances and margins atol 1e-5 on numpy-drawn configurations; labels equal
wherever the smallest margin is farther than that from 0), the hard scene
occupancy and the scene and request YAML round trips (each file read by
both packages), the learned models (a converted flax ``ProbMLP``'s forward
rtol 1e-5; 5 training steps from JAX's params and JAX's indices, params
rtol 1e-4; a save and load round trip) and their audit (``_metrics`` equal
to JAX's on the same predictions and labels, ties and one-class labels
included; both ``verify_*_model`` audits of converted models equal to
JAX's on JAX's draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import verify_learned as jvl
from sigsvgd_tpu.experiments.robot_planning import OCC_TRAIN_MARGIN
from sigsvgd_tpu.models.learning import mlp as jmlp
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot import scene as jscene
from sigsvgd_tpu.models.robot import self_collision as jsc
from sigsvgd_tpu_torch.convert import prob_model_from_numpy
from sigsvgd_tpu_torch.experiments import verify_learned as tvl
from sigsvgd_tpu_torch.models.learning.mlp import ProbModel, train_prob_model
from sigsvgd_tpu_torch.models.robot import scene as tscene
from sigsvgd_tpu_torch.models.robot import self_collision as tsc
from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

MARGIN_TOL = 1e-5


def _n(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def robots():
    return JPandaRobot.create(), PandaRobot.create(device="cpu")


@pytest.fixture(scope="module")
def configs(robots):
    jr, _ = robots
    lo, hi = (_n(a) for a in jr.joint_limits())
    return np.random.default_rng(7).uniform(lo * 0.9, hi * 0.9, size=(64, 7)).astype(
        np.float32)


def test_velocity_limits_and_ee_pose(robots, configs):
    jr, tr = robots
    np.testing.assert_array_equal(tr.velocity_limits().numpy(), _n(jr.velocity_limits()))
    pj, rj = jr.ee_pose(jnp.asarray(configs))
    pt, rt = tr.ee_pose(_t(configs))
    np.testing.assert_allclose(pt.numpy(), _n(pj), atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), _n(rj), atol=1e-6)


def test_jacobian_matches_jacfwd(robots, configs):
    jr, tr = robots
    jac = tr.jacobian(_t(configs[:8]).reshape(2, 4, 7))
    assert jac.shape == (2, 4, 3, 7)
    np.testing.assert_allclose(jac.reshape(8, 3, 7).numpy(),
                               _n(jr.jacobian(jnp.asarray(configs[:8]))), atol=1e-5)


def test_ik_matches_jax_after_100_iterations(robots):
    jr, tr = robots
    q_true = np.asarray([[0.3, -0.5, 0.2, -1.8, 0.1, 1.5, 0.4],
                         [1.0, -0.8, 0.5, -2.2, 0.3, 1.6, 0.7]], np.float32)
    targets = _n(jr.ee_position(jnp.asarray(q_true)))
    qj = _n(jr.ee_xs_to_qs(jnp.asarray(targets), iters=100))
    qt = tr.ee_xs_to_qs(_t(targets), iters=100)
    np.testing.assert_allclose(qt.numpy(), qj, atol=1e-4)
    err = np.linalg.norm(tr.ee_position(qt).numpy() - targets, axis=-1)
    assert (err < 0.01).all(), err


def test_segment_distance_and_margins(robots, configs):
    jr, tr = robots
    seg = np.random.default_rng(3).standard_normal((4, 50, 3)).astype(np.float32)
    seg[1, :5] = seg[0, :5] + 0.5 * (seg[2, :5] - seg[0, :5])  # crossing segments
    seg[3, 5:10] = seg[2, 5:10] + (seg[1, 5:10] - seg[0, 5:10])  # parallel segments
    np.testing.assert_allclose(tsc.segment_distance(*map(_t, seg)).numpy(),
                               _n(jsc.segment_distance(*map(jnp.asarray, seg))),
                               atol=MARGIN_TOL)
    qs = np.concatenate([configs, np.asarray(
        [[0.0, 1.7, 0.0, -2.9, 0.0, 3.6, 0.0], [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]],
        np.float32)])
    mj = _n(jsc.self_collision_margins(jr, jnp.asarray(qs)))
    mt = tsc.self_collision_margins(tr, _t(qs)).numpy()
    np.testing.assert_allclose(mt, mj, atol=MARGIN_TOL)
    lj = _n(jsc.self_collision(jr, jnp.asarray(qs)))
    lt = tsc.self_collision(tr, _t(qs)).numpy()
    away = np.abs(mj.min(-1)) > MARGIN_TOL
    np.testing.assert_array_equal(lt[away], lj[away])
    assert lt[-2] == 1.0 and lt[-1] == 0.0 and 0.0 < lt.mean() < 1.0
    # the dataset sampler labels the configurations it is given
    qd, ld = tsc.sample_self_collision_dataset(tr, len(qs), qs=_t(qs))
    np.testing.assert_array_equal(ld, lt)
    with pytest.raises(ValueError, match="generator"):
        tsc.sample_self_collision_dataset(tr, 4)


def test_scene_occupancy_and_yaml_round_trips(tmp_path):
    pts = np.random.default_rng(5).uniform((-1, -1, 0), (1, 1, 1.5), size=(4000, 3)).astype(
        np.float32)
    for tag in ("cage", "table_pick", "kitchen"):
        js, ts = jscene.get_scene(tag), tscene.get_scene(tag, device="cpu")
        dj = _n(jscene.scene_sdf(js, jnp.asarray(pts)))
        for margin in (0.0, 0.03):
            oj = _n(jscene.scene_occupancy(js, jnp.asarray(pts), margin))
            ot = tscene.scene_occupancy(ts, _t(pts), margin).numpy()
            away = np.abs(dj - margin) > MARGIN_TOL
            np.testing.assert_array_equal(ot[away], oj[away])
        p, lab = tscene.sample_occupancy_dataset(ts, len(pts), 0.03, pts=_t(pts))
        np.testing.assert_array_equal(p, pts)
        assert 0.0 < lab.mean() < 0.5
        # YAML: each package reads the other's file
        tscene.save_scene(ts, tmp_path / f"{tag}_t.yaml")
        jscene.save_scene(js, tmp_path / f"{tag}_j.yaml")
        assert jscene.load_scene(tmp_path / f"{tag}_t.yaml").primitives == js.primitives
        back = tscene.load_scene(tmp_path / f"{tag}_j.yaml", device="cpu")
        assert back.primitives == ts.primitives
        assert (back.workspace_low, back.workspace_high) == (js.workspace_low,
                                                              js.workspace_high)
        assert tscene.scene_from_dict(jscene.scene_to_dict(js), device="cpu") == ts
    gen = torch.Generator().manual_seed(0)
    p, lab = tscene.sample_occupancy_dataset(tscene.get_scene("cage", device="cpu"), 2000,
                                             generator=gen)
    assert p.shape == (2000, 3) and 0.0 < lab.mean() < 0.5
    req = tscene.PathRequest(start=(0.0,) * 7, target=(0.5,) * 7)
    req.to_yaml(tmp_path / "req_t.yaml")
    jreq = jscene.PathRequest.from_yaml(tmp_path / "req_t.yaml")
    jreq.to_yaml(tmp_path / "req_j.yaml")
    back = tscene.PathRequest.from_yaml(tmp_path / "req_j.yaml")
    assert (jreq.start, jreq.target) == (req.start, req.target) == (back.start, back.target)


def _jax_params_and_indices(key, x, features, batch_size, n_steps):
    """JAX's initial params and the batch indices its ``train`` scan draws."""
    module = jmlp.ProbMLP(features=features)
    params = module.init(key, jnp.zeros((1, x.shape[1])))["params"]
    keys = jax.random.split(jax.random.fold_in(key, 1), n_steps)
    idx = jax.vmap(lambda k: jax.random.randint(k, (batch_size,), 0, x.shape[0]))(keys)
    return jax.tree_util.tree_map(np.asarray, params), _n(idx)


def test_converted_model_and_training_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((640, 3)).astype(np.float32)
    y = (x[:, 0] > 0.4).astype(np.float32)
    key, feats = jax.random.PRNGKey(0), (8, 8)
    params0, idx = _jax_params_and_indices(key, x, feats, 128, 5)
    jmodel0 = jmlp.ProbModel(module=jmlp.ProbMLP(features=feats),
                             params=jax.tree_util.tree_map(jnp.asarray, params0))
    tmodel0 = prob_model_from_numpy(params0, feats, device="cpu")
    for logits in (False, True):
        np.testing.assert_allclose(tmodel0(x, logits=logits).detach().numpy(),
                                   _n(jmodel0(jnp.asarray(x), logits=logits)), rtol=1e-5,
                                   atol=1e-7)
    # 5 steps (1 epoch of 640 // 128) from JAX's params on JAX's batches
    jmodel = jmlp.train_prob_model(key, x, y, features=feats, epochs=1, batch_size=128)
    tmodel = train_prob_model(None, x, y, features=feats, epochs=1, batch_size=128,
                              device="cpu", init_params=params0, indices=idx)
    for i, layer in enumerate(tmodel.module.layers):
        p = jmodel.params[f"Dense_{i}"]
        np.testing.assert_allclose(layer.weight.detach().numpy().T, _n(p["kernel"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(layer.bias.detach().numpy(), _n(p["bias"]), rtol=1e-4,
                                   atol=1e-6)
    assert tmodel.epoch_losses.shape == (1,) and np.isfinite(tmodel.epoch_losses).all()
    # save and load
    tmodel.save(tmp_path / "m.pt")
    back = ProbModel.load(tmp_path / "m.pt", in_dim=3, features=feats, device="cpu")
    np.testing.assert_array_equal(back(x[:10]).detach().numpy(),
                                  tmodel(x[:10]).detach().numpy())
    with pytest.raises(ValueError, match="features"):
        ProbModel.load(tmp_path / "m.pt", in_dim=3, features=(4,), device="cpu")
    # from a generator: a model that learns a balanced split (the JAX save
    # and load test's data), and the audit's metrics
    gen = torch.Generator().manual_seed(1)
    y0 = (x[:, 0] > 0).astype(np.float32)
    fit = train_prob_model(gen, x, y0, features=(32,), epochs=20, batch_size=128,
                           device="cpu")
    assert fit.epoch_losses[-1] < fit.epoch_losses[0]
    m = tvl._metrics(fit(x)[:, 0].detach().numpy(), y0)
    assert m["accuracy"] > 0.85 and m["auc"] > 0.95, m
    with pytest.raises(ValueError, match="generator"):
        train_prob_model(None, x, y, features=feats, device="cpu")




def _close_pairs(pred, label, tol):
    """How many positive-negative pairs lie within ``tol`` of each other.
    Moving each prediction by at most ``tol / 2`` can reorder only those
    pairs, and moves the rank-sum AUC by one in ``n_pos * n_neg`` for each
    pair it reorders."""
    pos, neg = pred[label == 1], pred[label == 0]
    return int((np.abs(pos[:, None] - neg[None, :]) <= tol).sum())


def test_learned_model_audit_matches_jax(robots):
    """``_metrics`` equals JAX's on the same predictions and labels (ties,
    predictions at the threshold, one-class labels). Both audits of a
    converted flax ``ProbMLP`` (widths (8, 8)) on JAX's own draws (2,000
    points of ``table_pick``, 2,000 configurations, key 123) equal JAX's
    metrics of JAX's predictions with the port's exact labels. Those labels
    equal JAX's wherever the distance to the threshold (``sdf - margin``, the
    smallest capsule margin) is over ``MARGIN_TOL``, and the predictions
    agree (rtol 1e-5) and fall on the same side of 0.5: the hard-label
    metrics equal to rounding, the AUC within the pairs the gap can reorder
    (``_close_pairs``). The models' biases are drawn so that few inputs
    find every unit dead. ``want`` is JAX's audit itself, which is JAX's
    metrics of the same predictions with JAX's labels."""
    jr, tr = robots
    rng = np.random.default_rng(4)
    pred = rng.uniform(size=300).astype(np.float32)
    pred[:90] = np.round(pred[:90], 1)  # ties, some of them at 0.5
    label = (rng.uniform(size=300) < pred).astype(np.float32)
    for lab in (label, np.zeros_like(label), np.ones_like(label)):
        for thr in (0.5, 0.3):
            assert tvl._metrics(pred, lab, thr) == jvl._metrics(pred, lab, thr)

    n, feats = 2000, (8, 8)
    key = jax.random.PRNGKey(123)
    js, ts = jscene.get_scene("table_pick"), tscene.get_scene("table_pick", device="cpu")
    pts, occ = jscene.sample_occupancy_dataset(js, key, n, margin=OCC_TRAIN_MARGIN)
    qs, coll = jsc.sample_self_collision_dataset(jr, key, n)
    cases = (
        (pts, occ, _n(jscene.scene_sdf(js, jnp.asarray(pts))) - OCC_TRAIN_MARGIN,
         tscene.sample_occupancy_dataset(ts, n, OCC_TRAIN_MARGIN, pts=_t(pts))[1],
         lambda m: jvl.verify_occupancy_model(m, js, n=n),
         lambda m: tvl.verify_occupancy_model(m, ts, pts=_t(pts))),
        (qs, coll, _n(jsc.self_collision_margins(jr, jnp.asarray(qs))).min(-1),
         tsc.sample_self_collision_dataset(tr, n, qs=_t(qs))[1],
         lambda m: jvl.verify_self_collision_model(m, jr, n=n),
         lambda m: tvl.verify_self_collision_model(m, tr, qs=_t(qs))),
    )
    for seed, (x, lab, dist, lab_t, audit_j, audit_t) in enumerate(cases):
        away = np.abs(dist) > MARGIN_TOL
        np.testing.assert_array_equal(lab_t[away], lab[away])
        params = jmlp.ProbMLP(features=feats).init(jax.random.PRNGKey(seed),
                                                   jnp.zeros((1, x.shape[1])))["params"]
        params = jax.tree_util.tree_map(np.array, params)
        for layer in params.values():
            layer["bias"] = rng.normal(0.0, 0.5, layer["bias"].shape).astype(np.float32)
        jmodel = jmlp.ProbModel(module=jmlp.ProbMLP(features=feats),
                                params=jax.tree_util.tree_map(jnp.asarray, params))
        tmodel = prob_model_from_numpy(params, feats, device="cpu")
        pj = _n(jmodel(jnp.asarray(x)))[:, 0]
        pt = tvl._predict(tmodel, np.array(x))
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)
        assert 0.0 < lab_t.mean() < 1.0
        np.testing.assert_array_equal(pt >= 0.5, pj >= 0.5)
        n_pairs = _close_pairs(pj, lab_t, 2 * float(np.abs(pt - pj).max()))
        want = audit_j(jmodel)
        assert want == jvl._metrics(pj, lab)
        got, ref = audit_t(tmodel), jvl._metrics(pj, lab_t)
        got_auc = got.pop("auc")
        assert abs(got_auc - ref.pop("auc")) <= n_pairs / (
            lab_t.sum() * (1 - lab_t).sum()) + 1e-12, (n_pairs, want)
        assert got == pytest.approx(ref, rel=1e-12), (got, want)
