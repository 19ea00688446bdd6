"""The tile-sharded mode of the port (`gsplat_tpu_torch.parallel`) on the
CPU: 2 and 4 ranks of a gloo process group, one spawned process each,
against the JAX package's tile-sharded functions on conftest's 8 virtual
CPU devices (mirroring tests/test_sharding.py, with its tolerances). One
spawn per world size runs every case (`torch_rank_bodies.sharding_world`,
which imports no JAX); the JAX side takes the same numpy inputs."""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_rank_bodies  # noqa: E402
from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene, render  # noqa: E402
from gsplat_tpu.parallel.sharding import make_mesh as jax_mesh  # noqa: E402
from gsplat_tpu.parallel.sharding import render_tile_sharded as jax_tile_sharded  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_optimizer  # noqa: E402
from gsplat_tpu.parallel.train_step import make_sharded_train_step as jax_step  # noqa: E402
from gsplat_tpu.parallel.train_step import shard_batch as jax_shard_batch  # noqa: E402
from gsplat_tpu.train.losses import rgb_loss  # noqa: E402
from gsplat_tpu_torch.parallel import multihost  # noqa: E402
from gsplat_tpu_torch.parallel.sharding import Mesh, local_tile_cfg  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402

FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
CFG_KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
              max_tiles_per_gaussian=64, block_size=8, max_per_tile=256)
CFG = JaxConfig(**CFG_KW)
# Launch limit: a rank that fails or hangs ends the spawn well inside it.
TIMEOUT_S = 300


def np_scene(scene) -> dict:
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


def jax_scene(key: int, n: int, sh: int):
    return random_scene(jax.random.key(key), n, sh_degree=sh)


def uniform(key: int):
    return np.asarray(jax.random.uniform(jax.random.key(key), (64, 64, 3)))


@pytest.fixture(scope="module")
def inputs():
    cam = JaxCamera.default(64, 64)
    inp = {"cfg": CFG_KW,
           "cam": {f: np.asarray(getattr(cam, f)) for f in CAM_FIELDS}}
    # The scenes and targets of tests/test_sharding.py's cases.
    for key, (k, n, sh, target) in {
        "render": (0, 200, 2, None),
        "tiered": (9, 220, 2, 10),
        "p16": (11, 220, 2, 12),
        "loss": (3, 100, 1, 4),
        "ssim": (5, 120, 1, 6),
        "train16": (13, 150, 1, 14),
        "fit": (15, 120, 1, 16),
    }.items():
        inp[f"scene_{key}"] = np_scene(jax_scene(k, n, sh))
        if target is not None:
            inp[f"target_{key}"] = uniform(target)
    inp["scene_train"] = np_scene(jax_scene(1, 150, 1))
    inp["target_train"] = np.asarray(
        render(jax_scene(2, 150, 1), cam, CFG).image)
    return inp


def _spawn(world, inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"tiles{world}")
    return multihost.launch(torch_rank_bodies.sharding_world, world,
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
def test_tile_sharded_render_matches_jax(n_shards, request, inputs):
    ranks = request.getfixturevalue(f"world{n_shards}")
    scene = jax_scene(0, 200, 2)
    cam = JaxCamera.default(64, 64)
    mesh = jax_mesh({"tiles": n_shards})
    img, trans, ovf = jax.jit(
        lambda s, c: jax_tile_sharded(s, c, CFG, mesh))(scene, cam)
    for got in ranks:  # every rank holds the whole image
        got = got["render"]
        assert not got["overflow"] and not bool(ovf)
        np.testing.assert_allclose(got["image"], np.asarray(img),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["trans"], np.asarray(trans),
                                   rtol=1e-4, atol=1e-6)


def test_local_tile_cfg_rejects_indivisible():
    with pytest.raises(ValueError):
        local_tile_cfg(RenderConfig(**CFG_KW), 3)  # tiles_y = 8


def test_sharded_train_step_reduces_loss(world4):
    """11 steps on a data 2 x tiles 2 mesh: the loss falls, and the
    replicated scene stays bit-identical on all four ranks."""
    losses = world4[0]["train"]["loss"]
    assert np.all(np.isfinite(losses)) and len(losses) == 11
    assert losses[-1] < losses[0], losses
    for r in world4[1:]:
        assert r["train"]["loss"] == losses
        for f in FIELDS:
            np.testing.assert_array_equal(r["train"]["scene"][f],
                                          world4[0]["train"]["scene"][f])


def test_sharded_loss_matches_jax(world4, inputs):
    """One step's L1 loss (ssim_weight 0) equals the JAX sharded step's and
    the single-device L1 within 1e-5."""
    scene = jax_scene(3, 100, 1)
    cam = JaxCamera.default(64, 64)
    target = jnp.asarray(inputs["target_loss"])
    mesh = jax_mesh({"data": 2, "tiles": 2})
    opt = jax_optimizer(lr=0.0)
    step = jax_step(CFG, mesh, opt, ssim_weight=0.0)
    cams = jax.tree.map(lambda x: jnp.stack([x] * 2), cam)
    cams_s, targets_s = jax_shard_batch(cams, jnp.stack([target] * 2), mesh)
    _, loss, _, _ = step(init_train_state(scene, opt), cams_s, targets_s)
    ref = float(jnp.mean(jnp.abs(render(scene, cam, CFG).image - target)))
    got = world4[0]["l1_loss"]["loss"][0]
    assert abs(got - float(loss)) < 1e-5
    assert abs(got - ref) < 1e-5


@pytest.mark.parametrize("n_tiles", [2, 4])
def test_sharded_ssim_matches_jax(n_tiles, world4, inputs):
    """The default L1 + 0.2 DSSIM loss across band boundaries (the halo
    exchange) equals the single-device rgb_loss within 1e-5 (data 2 x tiles
    2, and tiles 4), and the all-reduced gradients and screen-space tap
    gradients equal JAX's single-device ones within rtol 2e-3 / atol
    2e-6."""
    got = world4[0][f"ssim_{n_tiles}"]
    assert not got["overflow"]
    scene = jax_scene(5, 120, 1)
    cam = JaxCamera.default(64, 64)
    target = jnp.asarray(inputs["target_ssim"])
    ref = float(rgb_loss(render(scene, cam, CFG).image, target, 0.2))
    assert abs(got["loss"][0] - ref) < 1e-5

    def loss_fn(s, tap):
        from gsplat_tpu.render.pipeline import render as jrender

        img = jrender(s, cam, CFG, uv_tap=tap).image
        return rgb_loss(img, target, 0.2)

    tap = jnp.zeros((scene.num_gaussians, 2), jnp.float32)
    g, g_tap = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(scene, tap)
    for f in FIELDS:
        np.testing.assert_allclose(got["grads"][f], np.asarray(getattr(g, f)),
                                   rtol=2e-3, atol=2e-6)
    np.testing.assert_allclose(got["tap"], np.asarray(g_tap), rtol=2e-3,
                               atol=2e-6)


def test_sharded_ssim_rejects_short_bands():
    from gsplat_tpu_torch.parallel.train_step import make_sharded_train_step
    from gsplat_tpu_torch.train.loop import make_optimizer
    from gsplat_tpu_torch.models.gaussians import random_scene as t_scene

    cfg = RenderConfig(**dict(CFG_KW, width=32, height=32, tile_size=4))
    # A mesh of 8 tile shards seen from rank 0: 4-row bands < SSIM_HALO.
    mesh = Mesh(("tiles",), (8,), (0,), (None,), torch.device("cpu"), False)
    opt = make_optimizer(t_scene(10, sh_degree=1, device="cpu"), 1e-2)
    with pytest.raises(ValueError, match="halo"):
        make_sharded_train_step(cfg, mesh, opt)


def test_multihost_helpers_single_process():
    """The one-process contract of the helpers: initialize is a no-op
    without torchrun's environment, rank 0 is primary, the batch is whole,
    and a mesh can only have one rank."""
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()
    assert multihost.process_local_batch(4) == (4, 0)
    mesh = multihost.global_mesh({"tiles": 1}, device="cpu")
    assert mesh.shape == {"tiles": 1} and mesh.rank == 0
    with pytest.raises(ValueError, match="mesh needs 8 ranks"):
        multihost.global_mesh({"tiles": 8}, device="cpu")
    with pytest.raises(ValueError, match="name the backend"):
        multihost.initialize(init_method="file:///nonexistent", world_size=1)


@pytest.mark.parametrize("how, limit_s, message", [
    ("raise", TIMEOUT_S, "rank 1 raised"),
    ("exit", TIMEOUT_S, "rank 1 exited"),
    ("hang", 20, "launch failed"),
])
def test_launch_stops_every_rank_when_one_fails(how, limit_s, message,
                                                tmp_path):
    """One rank that raises, exits or hangs while the other waits for it
    in a collective: launch stops both and raises, with the failed rank's
    message, within the limit (a hang at the limit)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=message):
        multihost.launch(torch_rank_bodies.failing_rank, 2, (how,),
                         backend="gloo", out_dir=str(tmp_path), device="cpu",
                         timeout_s=limit_s)
    assert time.monotonic() - t0 < limit_s + 60


def test_tile_sharded_tiered_grads_match_jax(world4, inputs):
    """Tiered binning under tile sharding (the per-shard counts of the
    gather backward): gradients equal JAX's sharded gradients within rtol
    2e-3 / atol 2e-6, and every rank holds the same whole gradients."""
    cfg = dataclasses.replace(CFG, binning="tiered")
    mesh = jax_mesh({"tiles": 4})
    scene = jax_scene(9, 220, 2)
    cam = JaxCamera.default(64, 64)
    target = jnp.asarray(inputs["target_tiered"])

    def sharded_loss(s):
        img, _, _ = jax_tile_sharded(s, cam, cfg, mesh)
        return jnp.mean(jnp.abs(img - target))

    g = jax.jit(jax.grad(sharded_loss))(scene)
    for f in FIELDS:
        np.testing.assert_allclose(world4[0]["tiered_grads"]["grads"][f],
                                   np.asarray(getattr(g, f)), rtol=2e-3,
                                   atol=2e-6)
        for r in world4[1:]:
            np.testing.assert_array_equal(r["tiered_grads"]["grads"][f],
                                          world4[0]["tiered_grads"]["grads"][f])


def test_tile_sharded_packed16_matches_jax(world4, inputs):
    """packed16 under tile sharding: the band configs carry the global
    quant ranges. Image within rtol 1e-4 / atol 1e-5 and gradients within
    rtol 2e-3 / atol 2e-6 of JAX's sharded packed16 path."""
    cfg = dataclasses.replace(CFG, binning="tiered", stream_format="packed16")
    mesh = jax_mesh({"tiles": 4})
    scene = jax_scene(11, 220, 2)
    cam = JaxCamera.default(64, 64)
    target = jnp.asarray(inputs["target_p16"])
    img, _, ovf = jax.jit(lambda s, c: jax_tile_sharded(s, c, cfg, mesh))(
        scene, cam)
    got = world4[0]["packed16"]
    assert not got["overflow"] and not bool(ovf)
    np.testing.assert_allclose(got["image"], np.asarray(img), rtol=1e-4,
                               atol=1e-5)

    def sharded_loss(s):
        im, _, _ = jax_tile_sharded(s, cam, cfg, mesh)
        return jnp.mean(jnp.abs(im - target))

    g = jax.jit(jax.grad(sharded_loss))(scene)
    for f in FIELDS:
        np.testing.assert_allclose(got["grads"][f], np.asarray(getattr(g, f)),
                                   rtol=2e-3, atol=2e-6)


def test_sharded_train_step_packed16_runs(world4):
    losses = world4[0]["train16"]["loss"]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_fit_mesh_reduces_loss(world4):
    """fit(mesh=...) on data 2 x tiles 2 with densification: the loss
    falls, the scenes stay alike on every rank, only rank 0 logs, and the
    checkpoints are there."""
    fit0 = world4[0]["fit"]
    losses = [row["loss"] for row in fit0["metrics"]]
    assert losses[-1] < losses[0], losses
    assert fit0["ckpts"] == ["ckpt_000006.npz", "ckpt_000012.npz"]
    assert "'step': 12" in fit0["printed"]
    for r in world4[1:]:
        assert r["fit"]["printed"] == ""
        assert [row["loss"] for row in r["fit"]["metrics"]] == losses
        for f in FIELDS:
            np.testing.assert_array_equal(r["fit"]["scene"][f],
                                          fit0["scene"][f])


def test_bench_sharded_runs(world4):
    r = world4[0]["bench"]
    assert r["value"] > 0
    assert not r["details"]["overflow"]
    assert r["details"]["grad_psum_bytes_per_step"] > 0
    assert r["details"]["ssim_halo_bytes_per_step"] > 0
    assert r["details"]["per_shard_max_intersections"] == 1 << 12
    assert r["details"]["mesh"] == {"data": 1, "tiles": 4}
