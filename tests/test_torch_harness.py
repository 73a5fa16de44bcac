"""The harness utilities of the port against the JAX package's: the config
round trip through YAML (each package reads the other's file), the compiled
result tables on the same artifact folders, the plots and the live figure
writing the same files, the viewer's embedded JSON for ``bookshelf_small``
with a trajectory (equal to JAX's, floats to 1e-12), the session snapshot,
the seeded generator and the profiling timers on the CPU.
"""
import dataclasses
import json
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import compile_results as jcr
from sigsvgd_tpu.models import ParticleModel as JParticleModel
from sigsvgd_tpu.models.robot import get_scene as jget_scene
from sigsvgd_tpu.utils import config as jconfig
from sigsvgd_tpu.utils import helper as jhelper
from sigsvgd_tpu.utils import plots as jplots
from sigsvgd_tpu.utils import viewer as jviewer
from sigsvgd_tpu.utils.live_plot import LiveFigure as JLiveFigure
from sigsvgd_tpu_torch.experiments import compile_results as cr
from sigsvgd_tpu_torch.models.particle import ParticleModel
from sigsvgd_tpu_torch.models.robot.scene import get_scene
from sigsvgd_tpu_torch.utils import config, helper, plots, profiling, viewer
from sigsvgd_tpu_torch.utils.live_plot import LiveFigure


@dataclasses.dataclass(frozen=True)
class DummyConfig:
    steps: int = 10
    lr: float = 0.1
    kernel: str = "rbf"
    shape: tuple = (2, 3)


def test_config_round_trips_through_each_packages_yaml(tmp_path):
    cfg = DummyConfig(steps=42, lr=0.5)
    config.save_config(cfg, tmp_path / "port.yaml")
    jconfig.save_config(cfg, tmp_path / "jax.yaml")
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    assert config.load_config(DummyConfig, tmp_path / "jax.yaml") == \
        jconfig.load_config(DummyConfig, tmp_path / "port.yaml")
    over = ["steps=99", "kernel=signature", "lr=1e-3"]
    assert config.apply_overrides(cfg, over) == jconfig.apply_overrides(cfg, over)
    with pytest.raises(TypeError):
        config.apply_overrides(cfg, ["nope=1"])
    with pytest.raises(ValueError, match="Unknown config keys"):
        config.from_dict(DummyConfig, {"bogus": 1})


def _artifacts(root, save):
    for i, (method, success) in enumerate((("pathsig", True), ("sgd", False), ("svgd", True))):
        save(root / f"robot-s/{i}-1/{method}", data={"metrics": {
            "success": np.asarray([success, False, success]),
            "ee_path_length": np.asarray([1.5 + i, 2.5, 0.7 * (i + 1)])}})
    save(root / "robot-s/9-1/sgd", data={"metrics": {
        "success": np.asarray([True]), "ee_path_length": np.asarray([3.0])}})
    for seed, steps, reached in ((1, 100, True), (2, 150, False)):
        save(root / f"maze/seed{seed}/svmpc", data={
            "steps": steps, "costs": np.linspace(0, 1, steps), "reached_goal": reached})
    save(root / "maze/seed1/dust", data={"actions": np.zeros((7, 2)), "costs": [2.0]})


def test_compile_results_equal_jax_on_the_same_folders(tmp_path):
    _artifacts(tmp_path / "a", helper.save_progress)
    _artifacts(tmp_path / "b", jhelper.save_progress)
    for root in (tmp_path / "a", tmp_path / "b"):
        rows = cr.compile_planning_results(root)
        assert rows == jcr.compile_planning_results(root)
        assert cr.to_markdown(rows) == jcr.to_markdown(rows)
        mrows = cr.compile_maze_results(root / "maze")
        assert mrows == jcr.compile_maze_results(root / "maze")
    assert {r["method"]: r["success_rate"] for r in rows} == {
        "pathsig": 1.0, "sgd": 0.5, "svgd": 1.0}
    assert cr.to_markdown([]) == "(no results)"


def test_plots_write_the_files_jax_writes(tmp_path):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    kw = dict(map_size=(10, 10), map_cell_size=0.5, with_obstacle=True,
              init_state=(-4.0, -4.0, 0.0, 0.0), target_state=(4.0, 4.0, 0.0, 0.0))
    traj = rng.uniform(-4, 4, (20, 4)).astype(np.float32)
    rolls = rng.uniform(-4, 4, (5, 8, 4)).astype(np.float32)
    trace = rng.standard_normal((21, 30, 2)).astype(np.float32)
    for name, mod, model in (("port", plots, ParticleModel.create(device="cpu", **kw)),
                             ("jax", jplots, JParticleModel.create(**kw))):
        d = tmp_path / name
        fig, ax = plt.subplots()
        mod.render_maze(model, trajectory=traj, rollouts=rolls, ax=ax, path=d / "maze.png")
        plt.close(fig)
        frames = mod.plot_particles_2d(trace, out_dir=d / "frames", every=10)
        assert [f.name for f in frames] == ["frame_00000.png", "frame_00010.png",
                                            "frame_00020.png"]
        fig, ax = plt.subplots()
        mod.plot_mean_std_curves({"a": rng.random((3, 9)), "b": rng.random((3, 9))}, ax=ax)
        mod.plot_particle_ridgeline(rng.normal(2.0, 0.3, (50, 30)), ax=ax, true_value=2.0)
        fig.savefig(d / "curves.png")
        plt.close(fig)
        mod.plot_arm_trajectories(rng.normal(size=(3, 9, 3)), rng.random((2, 5, 3)),
                                  rng.random((10, 3)), path=d / "arms.png")
    port = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    jax_ = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert port == jax_ and len(port) == 6
    # the maze's map coordinates: the port's renders as JAX's, pixel for pixel
    a = plt.imread(tmp_path / "port" / "maze.png")
    b = plt.imread(tmp_path / "jax" / "maze.png")
    np.testing.assert_array_equal(a, b)


def test_live_figure_streams_as_jax(tmp_path):
    figs = {"port": LiveFigure(nrows=2, out_path=str(tmp_path / "port.png"), redraw_every=5),
            "jax": JLiveFigure(nrows=2, out_path=str(tmp_path / "jax.png"), redraw_every=5)}
    for i in range(12):
        figs["port"].append("loss", torch.tensor(1.0 / (i + 1)), panel=0)
        figs["jax"].append("loss", jnp.asarray(1.0 / (i + 1)), panel=0)
        for f in figs.values():
            f.append("bw", np.cos(0.3 * i), panel=1)
    for f in figs.values():
        assert f.n_redraws == 4
        f.set_series("trace", np.linspace(0, 1, 50) ** 2, panel=0)
        f.redraw()
    assert figs["port"]._series == figs["jax"]._series
    assert (tmp_path / "port.png").stat().st_size > 0
    for f in figs.values():
        f.close()


def _embedded(path):
    return json.loads(re.search(r"const D = (\{.*?\});\n", path.read_text()).group(1))


def _assert_json_close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_json_close(a[k], b[k])
    elif isinstance(a, list):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-12, atol=1e-12)
    else:
        assert a == pytest.approx(b, rel=1e-12)


def test_viewer_embeds_the_json_jax_embeds(tmp_path):
    rng = np.random.default_rng(1)
    frames = np.cumsum(rng.random((5, 8, 3)) * 0.1, axis=1)
    ee = rng.random((4, 10, 3))
    pts = rng.random((20, 3))
    kw = dict(arm_frames=frames, ee_trajectories=ee, points=pts, title="bookshelf")
    out = viewer.export_interactive_html(tmp_path / "port.html", scene=get_scene(
        "bookshelf_small", device="cpu"), **{**kw, "arm_frames": torch.from_numpy(frames)})
    want = jviewer.export_interactive_html(tmp_path / "jax.html",
                                           scene=jget_scene("bookshelf_small"), **kw)
    _assert_json_close(_embedded(out), _embedded(want))
    assert out.read_text().replace(json.dumps(_embedded(out)), "") == \
        want.read_text().replace(json.dumps(_embedded(want)), "")
    arms = viewer.export_interactive_html(tmp_path / "arm.html", arms=frames[:1])
    assert "display:none" in arms.read_text().replace(" ", "")


def test_session_snapshot_and_helpers(tmp_path):
    my_tensor = torch.arange(4.0)
    my_scalar = 7
    my_module = np  # does not pickle: listed as skipped
    helper.save_progress(tmp_path / "exp", data={"x": my_tensor}, session=True)
    snap = helper.load_session(tmp_path / "exp")
    np.testing.assert_array_equal(snap["vars"]["my_tensor"], np.arange(4.0))
    assert snap["vars"]["my_scalar"] == my_scalar
    assert "my_module" in snap["__skipped__"] and my_module is np
    np.testing.assert_array_equal(helper.load_progress(tmp_path / "exp")["x"], np.arange(4.0))
    a, b = helper.seed_key(3), helper.seed_key(3)
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    assert (helper.get_project_root() / "sigsvgd_tpu_torch").is_dir()
    assert helper.get_project_root() == jhelper.get_project_root()


def test_profiling_timers_run_on_the_cpu(tmp_path):
    timer = profiling.SectionTimer()
    x = torch.ones(256, 64)
    for _ in range(2):
        with timer.section("a", sync=x):
            x = x * 1.0
    assert timer.summary()["a"]["calls"] == 2

    def slow(z):  # at least 20 ms an application, whatever the host's load
        time.sleep(0.02)
        return z * 2.0

    def big(z):
        m = z @ z.T
        for _ in range(8):
            m = torch.tanh(m @ m) + 1e-3
        return m

    # the slope is seconds an application: ten more sleeps add >= 200 ms,
    # which the lower bound keeps even when the short run is delayed 100 ms
    assert profiling.slope_time(slow, x, reps_lo=2, reps_hi=12) > 0.01
    assert profiling.scan_time(big, x, reps=4) > 0.0
    with profiling.device_trace(tmp_path / "trace"):
        big(x)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
