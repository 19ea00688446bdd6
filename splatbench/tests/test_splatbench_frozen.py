"""The frozen copies draw today what the program's originals draw for the
same seed: the scene generators, look_at, the default pose and its
perspective."""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.models import gaussians
from gsplat_tpu_torch.ops import camera as cam
from splatbench import frozen


@pytest.mark.parametrize("kind", ["random", "realistic"])
def test_scene_draws_as_the_original(kind):
    seed = 2 ** 31 + 11
    ours = frozen.SCENES[kind](3000, 3, torch.Generator().manual_seed(seed),
                               "cpu")
    make = getattr(gaussians, f"{kind}_scene")
    theirs = make(3000, 3, generator=torch.Generator().manual_seed(seed),
                  device="cpu")
    for f in frozen.SCENE_FIELDS:
        assert torch.equal(ours[f], getattr(theirs, f)), f


def test_look_at_and_default_pose():
    for eye, target in (((0.1, -0.2, 3.0), (0.0, 0.0, 0.0)),
                        ((1.0, 2.0, -1.0), (0.3, 0.2, 0.1))):
        np.testing.assert_array_equal(frozen.look_at(eye, target),
                                      cam.look_at(eye, target))
    default = cam.Camera.default(1920, 1080, device="cpu")
    np.testing.assert_array_equal(frozen.default_view(), default.view.numpy())
    fov_x = frozen.focal2fov(1920.0, 1920)
    fov_y = frozen.focal2fov(1080.0, 1080)
    np.testing.assert_array_equal(
        frozen.perspective_matrix(frozen.DEFAULT_ZNEAR, frozen.DEFAULT_ZFAR,
                                  fov_x, fov_y), default.proj.numpy())
