"""The reference agrees with the program at a tiny size on the CPU (the
program's plain paths), its control, the reference in bfloat16, falls
outside the limits that the program keeps, and the reference in another
sound float32 order stays within them."""

import types

import pytest
import torch

from splatbench import compare, gen, port, run
from splatbench.kinds import render as render_kind
from splatbench.kinds import train as train_kind
from splatbench.reference import render as R
from splatbench.tests import helpers


@pytest.mark.parametrize("config", ["tiny-garden", "tiny-bicycle"])
def test_image_agrees_with_the_program(config):
    from gsplat_tpu_torch.render.pipeline import render

    cfg = run.load_json(helpers.DATA / "configs" / f"{config}.json")
    rc = cfg["render"]
    scene = gen.make_scene(cfg, 77, "cpu")
    for view in gen.view_matrices(dict(layout="disk", count=3, radius=0.1,
                                       turn=0.05)):
        with torch.no_grad():
            theirs = render(port.scene(scene),
                            port.camera(view, rc["width"], rc["height"], "cpu"),
                            port.render_config(rc)).image
        ours = R.render(scene, R.camera(view, rc["width"], rc["height"], "cpu"),
                        rc)["image"]
        nums = compare.image_numbers(theirs, ours)
        assert nums["frame_rmse"] < 1e-6 and nums["frame_max_abs"] < 1e-5


def _ctx(cell, seed):
    s = helpers.spec()
    config, traffic = run.load_cell(run.find_cell(s, cell), helpers.DATA)
    return types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("cell,kind", [(helpers.TRAIN, train_kind),
                                       (helpers.RENDER, render_kind)])
@pytest.mark.parametrize("seed", [3, 2 ** 32 + 1])
def test_control_fails_the_limits(cell, kind, seed):
    ctx = _ctx(cell, seed)
    kind.setup(ctx)
    kind.window(ctx, 5.0)
    kind.wind_down(ctx, False)
    limits = run.load_limits(cell, helpers.DATA)
    ok, checks = compare.judge(kind.numbers(ctx), limits)
    assert ok, checks
    ok, checks = compare.judge(kind.control(ctx), limits)
    assert not ok, checks


@pytest.mark.parametrize("cell,kind", [(helpers.TRAIN, train_kind),
                                       (helpers.RENDER, render_kind)])
def test_reordered_reference_keeps_the_limits(cell, kind):
    """The reference in another sound float32 order (the projection's
    matrix products batched) in the program's place stays within them."""
    ctx = _ctx(cell, 2 ** 31 + 11)
    kind.setup(ctx)
    kind.window(ctx, 5.0)
    kind.wind_down(ctx, False)
    kind.numbers(ctx)
    ok, checks = compare.judge(kind.control(ctx, "reorder"),
                               run.load_limits(cell, helpers.DATA))
    assert ok, checks
