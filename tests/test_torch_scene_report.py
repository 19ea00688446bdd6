"""The port's capacity report (`gsplat_tpu_torch.scene_report`) against
`scripts/scene_report.py` on one seeded PLY (CPU): the worst camera's JSON
on stdout equal, and each camera's on stderr."""

import importlib.util
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.io.ply import save_ply as jax_save_ply  # noqa: E402
from gsplat_tpu_torch import scene_report  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_script():
    """scripts/scene_report.py as a module (a script, not in a package)."""
    spec = importlib.util.spec_from_file_location(
        "scene_report_jax", ROOT / "scripts" / "scene_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    """About 2000 Gaussians, their splats grown so that rects span several
    16-pixel tiles at 128x128."""
    scene = jax_random_scene(jax.random.key(11), 2000, sh_degree=3)
    scene = scene.replace(log_scales=scene.log_scales + 1.0)
    path = tmp_path_factory.mktemp("report") / "scene.ply"
    jax_save_ply(scene, path)
    return str(path)


def _jsons(text):
    """The JSON objects of a stream: one per line, or one indented."""
    text = text.strip()
    if text.startswith("{\n"):
        return [json.loads(text)]
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("extra", [
    [],
    ["--tier-spec", "4:0,8:40,16:200", "--kmax", "16"],
])
def test_scene_report_matches_jax(jax_script, ply, extra, monkeypatch,
                                  capsys):
    flags = ["--ply", ply, "--width", "128", "--height", "128",
             "--tile-size", "16", "--orbit", "3", *extra]
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["scene_report.py", *flags, "--cpu"])
    jax_script.main()
    want = capsys.readouterr()
    assert scene_report.main([*flags, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert _jsons(got.out) == _jsons(want.out)
    assert _jsons(got.err) == _jsons(want.err)
    worst = _jsons(got.out)[0]
    assert worst["worst_of_cameras"] == 4
    assert worst["num_intersections"] > 0
    if extra:
        assert worst["rect_overflow"]  # rects past K_max 16 at this scale


def test_scene_report_jumbo_block(capsys):
    """The port's jumbo flags add the jumbo tiers' block to the report."""
    assert scene_report.main([
        "--scene", "realistic", "--n", "3000", "--width", "128",
        "--height", "128", "--tile-size", "16", "--kmax", "16",
        "--tier-spec", "4:0,8:40,16:200", "--orbit", "0",
        "--max-tiles-jumbo", "64", "--jumbo-tier-spec", "32:400,64:100",
        "--device", "cpu"]) == 0
    worst = _jsons(capsys.readouterr().out)[0]
    assert worst["worst_of_cameras"] == 1
    assert [t["k_hi"] for t in worst["jumbo"]["tiers"]] == [32, 64]
    assert worst["jumbo"]["jumbo_splats"] > 0
