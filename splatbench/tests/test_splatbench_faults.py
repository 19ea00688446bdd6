"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that leaves its state
unchanged, half of the batch left out of the loss, an answer altered
where it is produced (the training loss; the served image), and replays
of the captured step that read the first step's inputs."""

import pytest

from splatbench import faults, run
from splatbench.tests import helpers


def _broken_adam_step(self, closure=None):
    return None


def _half_loss(pred, target, ssim_weight=0.2):
    from gsplat_tpu_torch.train.losses import rgb_loss

    h = pred.shape[0] // 2
    return rgb_loss(pred[:h], target[:h], ssim_weight)


def _scaled_loss(pred, target, ssim_weight=0.2):
    from gsplat_tpu_torch.train.losses import rgb_loss

    return 1.01 * rgb_loss(pred, target, ssim_weight)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_training_fault_is_not_correct(fault, monkeypatch):
    from gsplat_tpu_torch.train import loop

    if fault == "unchanged":
        monkeypatch.setattr(loop.SceneAdam, "step", _broken_adam_step)
    else:
        monkeypatch.setattr(loop, "rgb_loss",
                            _half_loss if fault == "half" else _scaled_loss)
    res = helpers.run_tiny(helpers.TRAIN)
    assert res["correct"] is False, res["checks"]


def test_served_image_altered_is_not_correct(monkeypatch):
    from gsplat_tpu_torch.render import pipeline

    real = pipeline.render_jit

    def altered(scene, camera, cfg, background=None):
        out = real(scene, camera, cfg, background)
        out.image[:4, :4] += 0.1
        return out

    monkeypatch.setattr(pipeline, "render_jit", altered)
    res = helpers.run_tiny(helpers.RENDER)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["frame_max_abs"]["value"] == pytest.approx(0.1,
                                                                     rel=1e-3)


@pytest.mark.parametrize("on_card", [False,
                                     pytest.param(True, marks=pytest.mark.card)])
def test_stale_replays_are_not_correct(on_card, request):
    """The fault is confined to the calls after the first (on a card, the
    graph's replays): the first step reads as sound, the later ones not."""
    device = request.getfixturevalue("cuda_device") if on_card else "cpu"
    with faults.stale_replays():
        res = helpers.run_tiny(helpers.TRAIN, device=device,
                               seconds=1.0 if on_card else 0.3)
    limits = run.load_limits(helpers.TRAIN, helpers.DATA)
    checks = res["checks"]
    assert res["correct"] is False, checks
    assert checks["first_loss_gap"]["value"] <= limits["first_loss_gap"]
    assert checks["later_loss_gap"]["value"] > limits["later_loss_gap"]
