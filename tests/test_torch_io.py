"""PLY, cameras.json, PNG and checkpoint I/O of the port against the JAX
package (CPU): files written by one package read back in the other."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.io.cameras import load_cameras as jax_load_cameras  # noqa: E402
from gsplat_tpu.io.ply import load_ply as jax_load_ply  # noqa: E402
from gsplat_tpu.io.ply import save_ply as jax_save_ply  # noqa: E402
from gsplat_tpu.utils.image import read_png as jax_read_png  # noqa: E402
from gsplat_tpu.utils.image import to_uint8 as jax_to_uint8  # noqa: E402
from gsplat_tpu.utils.image import write_png as jax_write_png  # noqa: E402
from gsplat_tpu_torch.convert import scene_from_numpy, scene_to_numpy  # noqa: E402
from gsplat_tpu_torch.io.cameras import load_cameras  # noqa: E402
from gsplat_tpu_torch.io.ply import load_ply, save_ply  # noqa: E402
from gsplat_tpu_torch.utils.image import read_png, to_uint8, write_png  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
# The JAX round trip's own tolerance (tests/test_io.py).
RTOL = 1e-6


def _jax_scene(degree, n=48, seed=0):
    return jax_random_scene(jax.random.key(seed), n, sh_degree=degree)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_ply_written_by_jax_loads_in_the_port(tmp_path, degree):
    path = tmp_path / "jax.ply"
    jax_save_ply(_jax_scene(degree), path)
    want = jax_load_ply(path)
    got = load_ply(path, device="cpu")
    assert got.sh_degree == want.sh_degree == degree
    assert got.means.device.type == "cpu"
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_ply_written_by_the_port_loads_in_jax(tmp_path, degree):
    jscene = _jax_scene(degree, seed=1)
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f))
                               for f in SCENE_FIELDS), device="cpu")
    path = tmp_path / "port.ply"
    save_ply(scene, path)
    jax_path = tmp_path / "jax.ply"
    jax_save_ply(jscene, jax_path)
    assert path.read_bytes() == jax_path.read_bytes()
    want = jax_load_ply(path)
    got = scene_to_numpy(load_ply(path, device="cpu"))
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(want, f)), got[f],
                                   rtol=RTOL, err_msg=f)
        np.testing.assert_allclose(got[f], np.asarray(getattr(jscene, f)),
                                   rtol=RTOL, err_msg=f)


def test_ply_uchar_properties_match_jax(tmp_path):
    """A hand-written PLY with uchar colour properties (divided by 255) and
    an unused extra property."""
    names = ["x", "y", "z", "opacity", "scale_0", "scale_1", "scale_2",
             "rot_0", "rot_1", "rot_2", "rot_3"]
    rng = np.random.default_rng(3)
    n = 5
    dt = np.dtype([(nm, "<f4") for nm in names]
                  + [("f_dc_0", "u1"), ("f_dc_1", "u1"), ("f_dc_2", "u1"),
                     ("extra", "<i4")])
    rec = np.zeros(n, dt)
    for nm in names:
        rec[nm] = rng.normal(size=n)
    for c in range(3):
        rec[f"f_dc_{c}"] = rng.integers(0, 256, n)
    header = "ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
    header += "".join(f"property float {nm}\n" for nm in names)
    header += "".join(f"property uchar f_dc_{c}\n" for c in range(3))
    header += "property int extra\nend_header\n"
    data = header.encode() + rec.tobytes()
    got = load_ply(data, device="cpu")
    want = jax_load_ply(data)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL)


def test_ply_rejects_garbage(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_bytes(b"not a ply at all" * 10)
    with pytest.raises(ValueError):
        load_ply(p, device="cpu")
    with pytest.raises(ValueError):
        jax_load_ply(p)


def test_ply_rejects_ascii(tmp_path):
    p = tmp_path / "ascii.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 0\nend_header\n")
    with pytest.raises(ValueError, match="binary_little_endian"):
        load_ply(p, device="cpu")


def test_ply_rejects_missing_properties():
    data = (b"ply\nformat binary_little_endian 1.0\nelement vertex 0\n"
            b"property float x\nend_header\n")
    with pytest.raises(ValueError, match="missing"):
        load_ply(data, device="cpu")


def test_load_ply_defaults_to_cuda(tmp_path):
    path = tmp_path / "s.ply"
    jax_save_ply(_jax_scene(0, n=4), path)
    if torch.cuda.is_available():
        assert load_ply(path).means.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            load_ply(path)


def _cameras_json():
    rng = np.random.default_rng(5)
    entries = []
    for i in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        entries.append({
            "id": i, "img_name": f"{i:05d}", "width": 400 + 8 * i,
            "height": 300, "position": rng.normal(size=3).tolist(),
            "rotation": q.tolist(), "fx": 350.0 + i, "fy": 340.0,
        })
    entries.append({"id": 7, "width": 64, "height": 48, "position": [0, 0, 0],
                    "rotation": np.eye(3).tolist(), "fx": 60.0, "fy": 50.0})
    return json.dumps(entries)


@pytest.mark.parametrize("override", [{}, dict(width_override=200,
                                              height_override=100)])
def test_cameras_json_matches_jax(tmp_path, override):
    text = _cameras_json()
    path = tmp_path / "cameras.json"
    path.write_text(text)
    for src in (text, str(path)):
        got = load_cameras(src, device="cpu", **override)
        want = jax_load_cameras(src, **override)
        assert [n for n, _ in got] == [n for n, _ in want] == \
            ["00000", "00001", "00002", "7"]
        for (_, cam), (_, jcam) in zip(got, want):
            for f in CAM_FIELDS:
                np.testing.assert_array_equal(
                    getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)),
                    err_msg=f)


def test_png_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((17, 23, 3)).astype(np.float32)
    img[0, :4] = [-0.5, 1.5, 0.0]  # clipped
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(ours, img)
    jax_write_png(theirs, img)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(to_uint8(img), jax_to_uint8(img))
    back = read_png(ours)
    np.testing.assert_array_equal(back, jax_read_png(theirs))
    np.testing.assert_array_equal(to_uint8(back), to_uint8(img))
