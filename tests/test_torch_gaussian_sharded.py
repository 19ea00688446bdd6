"""The Gaussian-sharded mode of the port (`gsplat_tpu_torch.parallel`) on
the CPU: 2 and 4 ranks of a gloo process group, one spawned process each,
against the JAX package's Gaussian-sharded functions on conftest's 8
virtual CPU devices (mirroring tests/test_gaussian_sharded.py, with its
tolerances). One spawn per world size runs every case
(`torch_rank_bodies.gaussian_world`, which imports no JAX). Also: the
fragment-occupancy report against JAX's, and a per-shard checkpoint written
by the JAX package loaded into the port (`convert.py`)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_rank_bodies  # noqa: E402
from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene, render  # noqa: E402
from gsplat_tpu.parallel.gaussian_sharded import fragment_occupancy as jax_occupancy  # noqa: E402
from gsplat_tpu.parallel.gaussian_sharded import render_gaussian_sharded as jax_gauss  # noqa: E402
from gsplat_tpu.parallel.gaussian_train import make_gaussian_sharded_train_step as jax_gstep  # noqa: E402
from gsplat_tpu.parallel.gaussian_train import save_sharded_checkpoint as jax_save_sharded  # noqa: E402
from gsplat_tpu.parallel.gaussian_train import shard_train_state as jax_shard_state  # noqa: E402
from gsplat_tpu.parallel.sharding import make_mesh as jax_mesh  # noqa: E402
from gsplat_tpu.parallel.train_step import TrainState  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_optimizer  # noqa: E402
from gsplat_tpu.render.pipeline import render_loss  # noqa: E402
from gsplat_tpu.train.loop import make_train_step as jax_train_step  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy,
    scene_adam_from_jax_sharded_checkpoint,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.parallel import multihost  # noqa: E402
from gsplat_tpu_torch.parallel.gaussian_sharded import fragment_occupancy  # noqa: E402

FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
CFG_KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
              max_tiles_per_gaussian=64, block_size=8, max_per_tile=256,
              binning="packed")
CFG = JaxConfig(**CFG_KW)
# The JAX tests' packed16 config; the port has no impl / pallas_interpret.
P16 = dict(stream_format="packed16", gather_backward="bf16",
           grad_readout="bf16", segment_sum="pallas")
PACKED_CFG = dataclasses.replace(CFG, **P16, pallas_interpret=True)
TIMEOUT_S = 300


def np_scene(scene) -> dict:
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


def jax_scene(key: int, n: int, sh: int):
    return random_scene(jax.random.key(key), n, sh_degree=sh)


def train_fixture(n=120, cap=128, key=5):
    """tests/test_gaussian_sharded.py's `_train_fixture`."""
    scene = jax_scene(key, n, 1).pad_to(cap)
    cam = JaxCamera.default(64, 64)
    target = render(jax_scene(key + 1, n, 1), cam, CFG).image
    return scene, cam, target


def concat(ranks, key, field):
    return np.concatenate([r[key]["grads"][field] if "grads" in r[key]
                           else r[key]["scene"][field] for r in ranks])


@pytest.fixture(scope="module")
def inputs():
    cam = JaxCamera.default(64, 64)
    inp = {"cfg": CFG_KW,
           "cam": {f: np.asarray(getattr(cam, f)) for f in CAM_FIELDS}}
    for key, (k, n, sh) in {"render": (0, 240, 2), "ovf": (1, 240, 1),
                            "grad": (2, 120, 1), "frag": (5, 240, 2),
                            "p16": (6, 240, 2)}.items():
        inp[f"scene_{key}"] = np_scene(jax_scene(k, n, sh))
    inp["target_grad"] = np.asarray(
        jax.random.uniform(jax.random.key(3), (64, 64, 3)))
    scene, _, target = train_fixture()
    inp["scene_train"], inp["target_train"] = np_scene(scene), np.asarray(target)
    scene, _, target = train_fixture(n=80, cap=128, key=7)
    inp["scene_fit"], inp["target_fit"] = np_scene(scene), np.asarray(target)
    return inp


def _spawn(world, inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"gauss{world}")
    return multihost.launch(torch_rank_bodies.gaussian_world, world,
                            (world, inputs, str(out)), backend="gloo",
                            out_dir=str(out), device="cpu",
                            timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return _spawn(2, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return _spawn(4, inputs, tmp_path_factory)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_gaussian_sharded_matches_jax(n_shards, request):
    """The image and T on every rank equal JAX's Gaussian-sharded render
    within rtol 1e-4 / atol 1e-5 (1e-6 on T)."""
    ranks = request.getfixturevalue(f"world{n_shards}")
    mesh = jax_mesh({"gauss": n_shards})
    img, trans, ovf = jax.jit(lambda s, c: jax_gauss(s, c, CFG, mesh))(
        jax_scene(0, 240, 2), JaxCamera.default(64, 64))
    for r in ranks:
        assert not r["render"]["overflow"] and not bool(ovf)
        np.testing.assert_allclose(r["render"]["image"], np.asarray(img),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["render"]["trans"], np.asarray(trans),
                                   rtol=1e-4, atol=1e-6)


def test_gaussian_sharded_overflow_flag(world2):
    assert all(r["overflow"] for r in world2), \
        "a per-dest capacity of 8 must trip the overflow flag on every rank"


def test_gaussian_sharded_grads_match_jax(world4, inputs):
    """The shards' gradients, put together, equal JAX's sharded gradients
    within rtol 2e-3 / atol 2e-6: the exchange's transpose brought every
    band's contribution home."""
    mesh = jax_mesh({"gauss": 4})
    cam = JaxCamera.default(64, 64)
    target = jnp.asarray(inputs["target_grad"])

    def loss(s):
        img, _, _ = jax_gauss(s, cam, CFG, mesh)
        return jnp.mean(jnp.abs(img - target))

    g = jax.jit(jax.grad(loss))(jax_scene(2, 120, 1))
    for f in FIELDS:
        np.testing.assert_allclose(concat(world4, "grads", f),
                                   np.asarray(getattr(g, f)), rtol=2e-3,
                                   atol=2e-6)


def test_gauss_sharded_train_step_matches_jax(world4):
    """One N-sharded train step (L1 + 0.2 DSSIM, Adam lr 1e-2) equals JAX's
    sharded step: the loss within 1e-5, the updated scene within rtol 2e-3
    / atol 2e-5, the screen-space gradients within rtol 2e-3 / atol 2e-6,
    visibility exactly."""
    from gsplat_tpu.parallel.gaussian_train import shard_train_state

    mesh = jax_mesh({"gauss": 4})
    scene, cam, target = train_fixture()
    opt = jax_optimizer(lr=1e-2)
    step = jax_gstep(CFG, mesh, opt, scene, ssim_weight=0.2)
    st = shard_train_state(
        TrainState(scene, opt.init(scene), jnp.zeros((), jnp.int32)), mesh)
    cams = jax.tree.map(lambda x: x[None], cam)
    st, m, (sg, vis) = step(st, cams, target[None])
    got = [r["step"] for r in world4]
    assert not any(g["overflow"] for g in got) and not bool(m["overflow"])
    for g in got:
        assert abs(g["loss"] - float(m["loss"])) < 1e-5
    for f in FIELDS:
        np.testing.assert_allclose(
            np.concatenate([g["scene"][f] for g in got]),
            np.asarray(getattr(st.scene, f)), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(np.concatenate([g["tap"] for g in got]),
                               np.asarray(sg), rtol=2e-3, atol=2e-6)
    np.testing.assert_array_equal(
        np.concatenate([g["visible"] for g in got]), np.asarray(vis))


def test_gauss_sharded_fit_reduces_loss_with_densify(world4):
    fit = world4[0]["fit"]
    assert fit["rows"] == 32  # capacity 128 kept, a quarter per shard
    assert fit["metrics"][-1]["loss"] < fit["metrics"][0]["loss"]
    for r in world4[1:]:
        assert r["fit"]["metrics"] == fit["metrics"]


def test_per_shard_checkpoint_roundtrip(world4):
    """save_sharded_checkpoint writes one file per shard holding only its
    rows, and meta.npz; load_sharded_checkpoint restores the same arrays
    bit for bit and refuses another shard layout."""
    for r in world4:
        ck = r["ckpt"]
        assert ck["same"] and ck["step"] == 7
        assert ck["files"] == ["meta.npz"] + [f"shard_{k:05d}.npz"
                                              for k in range(4)]
        assert set(ck["rows"].values()) == {32}
        assert "shards" in ck["refused"]


def test_fit_gaussian_sharded_writes_per_shard_checkpoints(world4):
    assert world4[0]["fit"]["ckpt_files"] == (
        ["meta.npz"] + [f"shard_{k:05d}.npz" for k in range(4)])


def test_fragment_occupancy_matches_jax():
    """The host-side capacity report: the port's dict equals JAX's."""
    scene = jax_scene(11, 240, 1)
    cam = JaxCamera.default(64, 64)
    want = jax_occupancy(scene, cam, CFG, 4)
    got = fragment_occupancy(
        scene_from_numpy(**np_scene(scene), device="cpu"),
        camera_from_numpy(**{f: np.asarray(getattr(cam, f))
                             for f in CAM_FIELDS}, device="cpu"),
        RenderConfig(**CFG_KW), 4)
    assert got == want
    assert got["suggested_per_dest_capacity"] >= got["max_segment"] > 0


def test_fragment_format_bf16_close_to_f32(world4):
    """fragment_format='bf16' (the packed16 layout on the wire, bf16 pairs
    back) within bf16 tolerance of the f32 exchange, forward and back."""
    img_b = world4[0]["bf16"]["image"]
    img_f = world4[0]["f32"]["image"]
    assert not world4[0]["bf16"]["overflow"]
    assert float(np.abs(img_b - img_f).max()) < 2e-2
    assert float(np.abs(img_b - img_f).mean()) < 1e-3
    for f in FIELDS:
        a, b = concat(world4, "f32", f), concat(world4, "bf16", f)
        scale = max(float(np.abs(a).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= 0.03 * scale


def test_gaussian_sharded_packed16_matches_jax(world4):
    """The packed16 stream as the wire format: the render within rtol 1e-3
    / atol 1e-4 of JAX's single-device packed16 render, and the gradients
    within 0.02 of the largest of JAX's single-device packed16 gradients
    (tests/test_gaussian_sharded.py's bounds)."""
    cam = JaxCamera.default(64, 64)
    scene = jax_scene(6, 240, 2)
    ref = render(scene, cam, PACKED_CFG)
    assert not world4[0]["render16"]["overflow"]
    np.testing.assert_allclose(world4[0]["render16"]["image"],
                               np.asarray(ref.image), rtol=1e-3, atol=1e-4)
    target = jnp.asarray(
        np.asarray(jax.random.uniform(jax.random.key(3), (64, 64, 3))))
    g = jax.jit(jax.grad(lambda s: render_loss(s, cam, target, PACKED_CFG)))(
        jax_scene(2, 120, 1))
    for f in FIELDS:
        want = np.asarray(getattr(g, f))
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(concat(world4, "grads16", f) - want).max())
        assert err <= 0.02 * scale, (f, err / scale)


def test_gauss_sharded_train_step_packed16_matches_jax(world4):
    """One packed16 N-sharded step against JAX's single-device packed16
    step: the loss within 1e-4, the scene within rtol 5e-3 / atol 5e-5,
    visibility exactly."""
    scene, cam, target = train_fixture()
    opt = jax_optimizer(lr=1e-2)
    state = TrainState(scene, opt.init(scene), jnp.zeros((), jnp.int32))
    st, loss, _, (_, vis) = jax_train_step(PACKED_CFG, opt, 0.2)(
        state, jax.tree.map(lambda x: x[None], cam), target[None])
    got = [r["step16"] for r in world4]
    assert not any(g["overflow"] for g in got)
    assert abs(got[0]["loss"] - float(loss)) < 1e-4
    for f in FIELDS:
        np.testing.assert_allclose(
            np.concatenate([g["scene"][f] for g in got]),
            np.asarray(getattr(st.scene, f)), rtol=5e-3, atol=5e-5)
    np.testing.assert_array_equal(
        np.concatenate([g["visible"] for g in got]), np.asarray(vis))


def test_jax_sharded_checkpoint_loads_into_port(tmp_path):
    """A per-shard checkpoint written by the JAX package on an 8-shard mesh
    reads into the port shard by shard: every shard's scene and Adam
    moments equal the JAX rows, the counts and the step carried."""
    mesh = jax_mesh({"gauss": 8})
    scene, _, _ = train_fixture()
    opt = jax_optimizer(1e-2)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.5), scene)
    opt_state = opt.init(scene)
    _, opt_state = opt.update(grads, opt_state, scene)
    state = jax_shard_state(TrainState(scene, opt_state, jnp.ones((), jnp.int32) * 5),
                            mesh)
    d = str(tmp_path / "ck")
    jax_save_sharded(d, state, mesh)
    rows = scene.num_gaussians // 8
    inner = opt_state.inner_states
    for k in range(8):
        local, adam, step = scene_adam_from_jax_sharded_checkpoint(
            d, k, device="cpu")
        assert step == 5 and adam.updates == 1
        got = scene_to_numpy(local)
        for f in FIELDS:
            sl = slice(k * rows, (k + 1) * rows)
            np.testing.assert_array_equal(got[f], np.asarray(getattr(scene, f))[sl])
            adam_state = inner[f].inner_state[0]
            st = adam.state[getattr(local, f)]
            np.testing.assert_array_equal(
                st["exp_avg"].numpy(), np.asarray(getattr(adam_state.mu, f))[sl])
            np.testing.assert_array_equal(
                st["exp_avg_sq"].numpy(), np.asarray(getattr(adam_state.nu, f))[sl])
            assert float(st["step"]) == 1.0


def test_bench_gaussian_sharded_runs(world4):
    r = world4[0]["bench"]
    assert r["value"] > 0
    assert not r["details"]["overflow"]
    assert r["details"]["a2a_bytes_per_step"] > 0
    assert r["details"]["fragment_occupancy"]["max_segment"] > 0
    assert r["details"]["mesh"] == {"gauss": 4}
