"""The port's mesh obstacles, native collision engine, MoveIt importer and
Panda mesh audit against the JAX package's on the CPU.

* ``native/collision.py``: the port builds the repository's C++ engine into
  ``build/native/``; triangles, point distances (with and without a pose),
  mesh-to-mesh distances and surface samples bit-equal to the JAX wrapper's
  on a cube and the Panda's link meshes, and ``tests/test_native.py``'s
  closed forms.
* ``mesh_sdf_grid``: bit-equal to JAX's (the same engine, lattice and flood
  fill). ``grid_sdf``: values and gradients within 1e-6 of JAX's
  (``jax.grad``) inside, outside, on and beyond the lattice's border (JAX's
  half gradient at a clip tie, its clamped gather), with the interior's
  negative sign, and ``tests/test_robot.py``'s analytic-box check.
* ``scene_sdf`` over primitives and meshes within 1e-6 of JAX's, and the
  scene YAML round trip with meshes (``test_mesh_obstacle_in_scene_and_yaml``).
* ``robodata`` on MoveIt YAML files written by the test: the scene, request
  and trajectory equal to JAX's (``test_moveit_importer_round_trip``,
  ``test_moveit_importer_embedded_mesh``).
* ``PandaMeshVerifier``: ``test_mesh_verifier_free_vs_folded``, and a short
  audited trajectory in a scene against JAX's verifier (flags equal,
  distances within 1e-4: FK differs in the last bits).
"""
import dataclasses
import math
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sigsvgd_tpu.experiments.verify_mesh import PandaMeshVerifier as JVerifier
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot import load_moveit_request as j_load_request
from sigsvgd_tpu.models.robot import load_moveit_scene as j_load_scene
from sigsvgd_tpu.models.robot import load_moveit_trajectory as j_load_traj
from sigsvgd_tpu.models.robot import mesh_scene as jms
from sigsvgd_tpu.models.robot import scene as jscene
from sigsvgd_tpu.native import collision as jcol
from sigsvgd_tpu_torch.experiments.verify_mesh import PandaMeshVerifier
from sigsvgd_tpu_torch.models.robot import mesh_scene as tms
from sigsvgd_tpu_torch.models.robot import robodata
from sigsvgd_tpu_torch.models.robot import scene as tscene
from sigsvgd_tpu_torch.models.robot.panda import PandaRobot
from sigsvgd_tpu_torch.native import collision as tcol

PANDA_MESHES = Path(__file__).resolve().parents[1] / "robot_resources/panda/meshes/collision"
FREE_Q = [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]
FOLDED_Q = [0.0, 1.7, 0.0, -2.9, 0.0, 3.6, 0.0]


def _write_unit_cube_stl(path: Path):
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for a, b, c in faces:
            f.write(struct.pack("<3f", 0, 0, 0))
            for i in (a, b, c):
                f.write(struct.pack("<3f", *v[i]))
            f.write(struct.pack("<H", 0))


def test_native_engine_builds_under_build_and_matches_jax(tmp_path):
    lib = tcol.build_native_library()
    assert lib.exists() and lib.parent == tcol.BUILD_DIR
    assert lib.parent.relative_to(Path(__file__).resolve().parents[1] / "build")
    cube = tmp_path / "cube.stl"
    _write_unit_cube_stl(cube)
    tm, jm = tcol.TriMesh(cube), jcol.TriMesh(cube)
    assert tm.n_triangles == jm.n_triangles == 12
    pts = np.array([[0, 0, 0], [1.5, 0, 0], [0.5, 0, 0], [0, 2.5, 0]], np.float32)
    np.testing.assert_allclose(tm.point_distances(pts), [0.5, 1.0, 0.0, 2.0], atol=1e-5)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [10.0, 0.0, 0.0]
    np.testing.assert_allclose(tm.point_distances(np.array([[11.5, 0, 0]], np.float32), t),
                               [1.0], atol=1e-5)
    t2 = np.eye(4)
    t2[:3, 3] = [3.0, 0, 0]
    np.testing.assert_allclose(tm.distance_to(tcol.TriMesh(cube), np.eye(4), t2), 2.0,
                               atol=1e-4)
    t2[:3, 3] = [0.5, 0, 0]
    assert tm.distance_to(tcol.TriMesh(cube), np.eye(4), t2, stop_below=1e-4) < 1e-3
    np.testing.assert_allclose(np.abs(tm.surface_points(500)).max(axis=1), 0.5, atol=1e-5)

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = rot, [0.1, -0.2, 0.3]
    for link in ("link0", "link3", "hand"):
        tm, jm = tcol.TriMesh(PANDA_MESHES / f"{link}.stl"), jcol.TriMesh(PANDA_MESHES / f"{link}.stl")
        assert np.array_equal(tm.triangles(), jm.triangles())
        assert np.array_equal(tm.point_distances(pts), jm.point_distances(pts))
        assert np.array_equal(tm.point_distances(pts, pose), jm.point_distances(pts, pose))
        assert np.array_equal(tm.surface_points(50, seed=2), jm.surface_points(50, seed=2))
        other_t, other_j = tcol.TriMesh(PANDA_MESHES / "link5.stl"), jcol.TriMesh(
            PANDA_MESHES / "link5.stl")
        assert tm.distance_to(other_t, np.eye(4), pose) == jm.distance_to(other_j, np.eye(4),
                                                                          pose)
    d = tcol.TriMesh(PANDA_MESHES / "link0.stl").point_distances(
        np.array([[0, 0, 2.0]], np.float32))
    assert 1.5 < d[0] < 2.0
    with pytest.raises(FileNotFoundError):
        tcol.TriMesh(tmp_path / "missing.stl")


@pytest.fixture(scope="module")
def box_grids(tmp_path_factory):
    d = tmp_path_factory.mktemp("box")
    stl = d / "box.stl"
    tms.write_stl(stl, tms.box_mesh((0.4, 0.3, 0.4)))
    assert stl.read_bytes() == _jax_stl_bytes(d, (0.4, 0.3, 0.4))
    kw = dict(position=(0.05, -0.05, 0.5), margin=0.01, resolution=32)
    lo, hi = (-0.5, -0.5, 0.0), (0.5, 0.5, 1.0)
    return (tms.mesh_sdf_grid(tms.MeshObstacle(str(stl), **kw), lo, hi),
            jms.mesh_sdf_grid(jms.MeshObstacle(str(stl), **kw), lo, hi))


def _jax_stl_bytes(d: Path, extents):
    p = d / "jax_box.stl"
    jms.write_stl(p, jms.box_mesh(extents))
    return p.read_bytes()


def test_mesh_sdf_grid_is_bit_equal(box_grids):
    tg, jg = box_grids
    assert tg.origin == jg.origin and tg.spacing == jg.spacing
    assert tg.values.dtype == jg.values.dtype and np.array_equal(tg.values, jg.values)
    assert (tg.values < -0.1).any()  # the flood fill found the interior


def test_grid_sdf_values_and_gradients_match_jax(box_grids, rng):
    tg, jg = box_grids
    pts = np.concatenate([
        rng.uniform((-0.45, -0.45, 0.05), (0.45, 0.45, 0.95), (400, 3)),
        rng.uniform((-0.8, -0.8, -0.3), (0.8, 0.8, 1.3), (100, 3)),  # beyond the lattice
        [[-0.5, 0.0, 0.5], [0.5, 0.5, 1.0], [0.0, -0.5, 0.0],  # on its border (clip ties)
         [0.05, -0.05, 0.5], [0.1, 0.0, 0.62]],  # inside the box
    ]).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jms.grid_sdf(jg, p), jnp.asarray(pts))
    (want_g,) = vjp(jnp.ones_like(want))
    x = torch.from_numpy(pts).requires_grad_(True)
    got = tms.grid_sdf(tg, x)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    assert float(got[-2].detach()) < -0.1  # the box's centre is inside
    # the lattice is cached once per device
    assert torch.device("cpu") in tg._on_device and len(tg._on_device) == 1


def test_grid_sdf_matches_the_analytic_box_and_is_negative_inside(tmp_path):
    """``test_mesh_obstacle_grid_sdf_matches_analytic_box`` and
    ``test_mesh_interior_is_negative`` on the port."""
    stl = tmp_path / "box.stl"
    tms.write_stl(stl, tms.box_mesh((0.3, 0.2, 0.4)))
    obst = tms.MeshObstacle(str(stl), position=(0.1, -0.05, 0.6), margin=0.0, resolution=64)
    grid = tms.mesh_sdf_grid(obst, (-0.5, -0.5, 0.0), (0.7, 0.5, 1.2))
    ref = tscene.Primitive("box", (0.1, -0.05, 0.6), (0.3, 0.2, 0.4))
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        (-0.45, -0.45, 0.05), (0.65, 0.45, 1.15), (400, 3)).astype(np.float32))
    analytic = tscene._primitive_sdf(ref, pts).numpy()
    outside = analytic > 0.05
    got = tms.grid_sdf(grid, pts).numpy()
    np.testing.assert_allclose(got[outside], analytic[outside], atol=0.025)
    p = torch.tensor([0.1, -0.05, 0.85], requires_grad=True)
    (g,) = torch.autograd.grad(tms.grid_sdf(grid, p), p)
    assert float(g[2]) > 0.5
    solid = tmp_path / "solid.stl"
    tms.write_stl(solid, tms.box_mesh((0.4, 0.4, 0.4)))
    obst = tms.MeshObstacle(str(solid), position=(0.0, 0.0, 0.5), margin=0.0, resolution=48)
    grid = tms.mesh_sdf_grid(obst, (-0.5, -0.5, 0.0), (0.5, 0.5, 1.0))
    center = float(tms.grid_sdf(grid, torch.tensor([0.0, 0.0, 0.5])))
    assert center < -0.1, center
    p = torch.tensor([0.0, 0.0, 0.62], requires_grad=True)
    (g,) = torch.autograd.grad(tms.grid_sdf(grid, p), p)
    assert float(g[2]) > 0.3, g


def test_mesh_scene_sdf_and_yaml_match_jax(tmp_path, rng):
    stl = tmp_path / "slab.stl"
    tms.write_stl(stl, tms.box_mesh((0.4, 0.4, 0.1)))
    common = dict(name="mesh_test", workspace_low=(-0.6, -0.6, 0.0),
                  workspace_high=(0.6, 0.6, 1.0))
    ts = tscene.Scene(primitives=(tscene.Primitive("sphere", (0.4, 0.4, 0.4), (0.1,)),),
                      meshes=(tms.MeshObstacle(str(stl), position=(0.0, 0.0, 0.5)),),
                      device=torch.device("cpu"), **common)
    js = jscene.Scene(primitives=(jscene.Primitive("sphere", (0.4, 0.4, 0.4), (0.1,)),),
                      meshes=(jms.MeshObstacle(str(stl), position=(0.0, 0.0, 0.5)),), **common)
    d_slab = float(tscene.scene_sdf(ts, torch.tensor([0.0, 0.0, 0.62])))
    d_sph = float(tscene.scene_sdf(ts, torch.tensor([0.4, 0.4, 0.55])))
    assert 0.0 < d_slab < 0.12 and 0.0 < d_sph < 0.08
    pts = rng.uniform((-0.6, -0.6, 0.0), (0.6, 0.6, 1.0), (2000, 3)).astype(np.float32)
    np.testing.assert_allclose(tscene.scene_sdf(ts, torch.from_numpy(pts)).numpy(),
                               np.asarray(jscene.scene_sdf(js, jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6)
    _, labels = tscene.sample_occupancy_dataset(ts, 4000, generator=torch.Generator().manual_seed(0))
    assert 0.0 < labels.mean() < 0.5
    assert tscene.scene_to_dict(ts) == jscene.scene_to_dict(js)
    path = tmp_path / "scene.yaml"
    tscene.save_scene(ts, path)
    assert jscene.load_scene(path) == js
    loaded = tscene.load_scene(path, device="cpu")
    assert loaded == ts
    # a mesh-only scene: the mesh's grid alone
    only = tscene.Scene(primitives=(), meshes=ts.meshes, device=torch.device("cpu"), **common)
    assert float(tscene.scene_sdf(only, torch.tensor([0.0, 0.0, 0.62]))) == pytest.approx(
        d_slab, abs=1e-6)


def _moveit_files(tmp_path):
    s, c = math.sin(math.pi / 8), math.cos(math.pi / 8)
    ident = [0.0, 0.0, 0.0, 1.0]
    scene_doc = {"world": {"collision_objects": [
        {"id": "shelf", "pose": {"position": [0.5, 0.0, 0.0], "orientation": [0.0, 0.0, s, c]},
         "primitives": [{"type": "box", "dimensions": [0.4, 0.2, 0.1]},
                        {"type": "cylinder", "dimensions": [0.6, 0.05]}],
         "primitive_poses": [{"position": [0.0, 0.0, 0.3], "orientation": ident},
                             {"position": [0.0, 0.3, 0.3], "orientation": ident}]},
        {"id": "ball", "pose": {"position": [0.0, 0.0, 0.0], "orientation": ident},
         "primitives": [{"type": "sphere", "dimensions": [0.1]}],
         "primitive_poses": [{"position": [-0.4, 0.2, 0.5], "orientation": ident}]},
        {"id": "rock", "pose": {"position": [0.3, 0.0, 0.2], "orientation": ident},
         "meshes": [{"vertices": [[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0],
                                  [0.0, 0.0, 0.1]],
                     "triangles": [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]}],
         "mesh_poses": [{"position": [0.0, 0.0, 0.0], "orientation": ident}]},
    ]}}
    req_doc = {"start_state": {"joint_state": {
        "name": ["panda_joint2", "panda_joint1", "panda_finger_joint1"],
        "position": [0.2, 0.1, 0.03]}},
        "goal_constraints": [{"joint_constraints": [
            {"joint_name": "panda_joint1", "position": 0.5},
            {"joint_name": "panda_joint2", "position": -0.4}]}]}
    traj_doc = {"joint_trajectory": {"joint_names": ["panda_joint2", "panda_joint1"],
                                     "points": [{"positions": [0.2, 0.1]},
                                                {"positions": [0.25, 0.15]}]}}
    paths = []
    for name, doc in (("demo-scene0001", scene_doc), ("demo-scene0001_request0001", req_doc),
                      ("demo-scene0001_path0001", traj_doc)):
        paths.append(tmp_path / f"{name}.yaml")
        paths[-1].write_text(yaml.safe_dump(doc))
    return paths


def test_moveit_importer_matches_jax(tmp_path):
    spath, rpath, tpath = _moveit_files(tmp_path)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ts = robodata.load_moveit_scene(spath, mesh_dir=tmp_path / "t", device="cpu")
    js = j_load_scene(spath, mesh_dir=tmp_path / "j")
    assert ts.name == js.name == "demo-scene0001"
    assert len(ts.primitives) == 3
    assert [dataclasses.astuple(p) for p in ts.primitives] == [
        dataclasses.astuple(p) for p in js.primitives]
    box, cyl, _ = ts.primitives
    assert box.size == (0.4, 0.2, 0.1) and cyl.size == (0.05, 0.3)
    np.testing.assert_allclose(cyl.position, (0.5 - 0.3 * math.sin(math.pi / 4),
                                              0.3 * math.cos(math.pi / 4), 0.3), atol=1e-9)
    (tm,), (jm,) = ts.meshes, js.meshes
    assert tm.position == jm.position == (0.3, 0.0, 0.2) and tm.rot == jm.rot
    assert Path(tm.path).parent == tmp_path / "t"
    assert Path(tm.path).read_bytes() == Path(jm.path).read_bytes()
    raw = Path(tm.path).read_bytes()
    assert int(np.frombuffer(raw[80:84], np.uint32)[0]) == 4
    d = tscene.scene_sdf(ts, torch.tensor([[-0.4, 0.2, 0.5], [-0.9, -0.9, 1.4]])).numpy()
    assert d[0] < 0.0 < d[1]
    names = ["panda_joint1", "panda_joint2"]
    req = robodata.load_moveit_request(rpath, joint_names=names)
    want = j_load_request(rpath, joint_names=names)
    assert (req.start, req.target) == (want.start, want.target)
    assert req.start == (0.1, 0.2) and req.target == (0.5, -0.4)
    traj = robodata.load_moveit_trajectory(tpath, joint_names=names)
    np.testing.assert_array_equal(traj, j_load_traj(tpath, joint_names=names))
    np.testing.assert_allclose(traj, [[0.1, 0.2], [0.15, 0.25]], atol=1e-7)


@pytest.fixture(scope="module")
def verifiers():
    return (PandaMeshVerifier(PandaRobot.create(device="cpu"), surface_samples=100),
            JVerifier(JPandaRobot.create(), surface_samples=100))


def test_mesh_verifier_free_vs_folded(verifiers):
    tv, jv = verifiers
    free = tv.audit_config(np.array(FREE_Q))
    folded = tv.audit_config(np.array(FOLDED_Q))
    assert not free["self_collision"] and folded["self_collision"]
    assert folded["min_self_distance"] < free["min_self_distance"]
    want = jv.audit_config(np.array(FREE_Q))
    assert free["self_collision"] == want["self_collision"]
    np.testing.assert_allclose(free["min_self_distance"], want["min_self_distance"], atol=1e-4)


def test_audit_trajectory_matches_jax(verifiers):
    tv, jv = verifiers
    qs = np.linspace(FREE_Q, [0.5, 0.2, 0.3, -1.8, 0.1, 2.0, 0.4], 5).astype(np.float32)
    got = tv.audit_trajectory(qs, tscene.get_scene("pillars_4", device="cpu"))
    want = jv.audit_trajectory(qs, jscene.get_scene("pillars_4"))
    for k in ("env_collision", "self_collision"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["fraction_colliding"] == want["fraction_colliding"]
    assert got["collision_free"] == want["collision_free"]
    rows_t = [tv.audit_config(q, tscene.get_scene("pillars_4", device="cpu")) for q in qs[:2]]
    rows_j = [jv.audit_config(q, jscene.get_scene("pillars_4")) for q in qs[:2]]
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_allclose(a["min_env_sdf"], b["min_env_sdf"], atol=1e-4)
        np.testing.assert_allclose(a["min_self_distance"], b["min_self_distance"], atol=1e-4)
