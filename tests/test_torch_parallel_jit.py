"""The port's multi-device programs as captured programs (CPU): the
`*_jit` sharded renders, the sharded train steps and the Gaussian-sharded
densify program go through `utils/graphs.py`, which captures them on an
NCCL mesh on the card and runs the same bodies eagerly on gloo. On 2 gloo
ranks (one spawn, `torch_rank_bodies.parallel_jit_world`, which imports no
JAX) each is held bit for bit to its eager function, and its first call to
the JAX package's sharded function with the tolerances of
`tests/test_torch_sharding.py` and `tests/test_torch_gaussian_sharded.py`.
Also: the backend's choice of route, the key rule on a mesh (no address,
no weak key, LRU in call order), the ranks' agreement check, and the
captured single-device densify round against the eager one and JAX's."""

import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_rank_bodies  # noqa: E402
from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene, render  # noqa: E402
from gsplat_tpu.ops.camera import look_at as jax_look_at  # noqa: E402
from gsplat_tpu.parallel.gaussian_sharded import render_gaussian_sharded as jax_gauss  # noqa: E402
from gsplat_tpu.parallel.gaussian_train import make_gaussian_sharded_train_step as jax_gstep  # noqa: E402
from gsplat_tpu.parallel.gaussian_train import shard_train_state as jax_shard_state  # noqa: E402
from gsplat_tpu.parallel.sharding import make_mesh as jax_mesh  # noqa: E402
from gsplat_tpu.parallel.sharding import render_tile_sharded as jax_tile_sharded  # noqa: E402
from gsplat_tpu.parallel.train_step import TrainState, init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_optimizer  # noqa: E402
from gsplat_tpu.parallel.train_step import make_sharded_train_step as jax_step  # noqa: E402
from gsplat_tpu.parallel.train_step import shard_batch as jax_shard_batch  # noqa: E402
from gsplat_tpu.train import densify as jax_densify  # noqa: E402
from gsplat_tpu_torch.convert import scene_from_numpy, scene_to_numpy  # noqa: E402
from gsplat_tpu_torch.parallel import multihost  # noqa: E402
from gsplat_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from gsplat_tpu_torch.train import densify  # noqa: E402
from gsplat_tpu_torch.utils import graphs  # noqa: E402

FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
CFG_KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
              max_tiles_per_gaussian=64, block_size=8, max_per_tile=256,
              binning="packed")
CFG = JaxConfig(**CFG_KW)
WORLD = 2
TIMEOUT_S = 300


def np_scene(scene) -> dict:
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


def jax_scene(key: int, n: int, sh: int):
    return random_scene(jax.random.key(key), n, sh_degree=sh)


def two_views():
    cams = [JaxCamera.default(64, 64)]
    eye = np.asarray(cams[0].cam_pos, np.float64)
    view = jax_look_at(eye + [0.1, 0.0, 0.0], eye + [0.15, 0.0, 1.0],
                       up=(0.0, -1.0, 0.0))
    cams.append(JaxCamera.create(view, 64, 64, fx=64.0, fy=64.0, znear=0.2,
                                 zfar=10.0))
    return cams


def train_fixture():
    """tests/test_gaussian_sharded.py's `_train_fixture` (120 Gaussians in
    128 slots)."""
    scene = jax_scene(5, 120, 1).pad_to(128)
    target = render(jax_scene(6, 120, 1), JaxCamera.default(64, 64),
                    CFG).image
    return scene, target


@pytest.fixture(scope="module")
def inputs():
    inp = {"cfg": CFG_KW,
           "cams": [{f: np.asarray(getattr(c, f)) for f in CAM_FIELDS}
                    for c in two_views()]}
    inp["scene_render"] = np_scene(jax_scene(0, 240, 2))
    inp["scene_step"] = np_scene(jax_scene(3, 150, 1))
    inp["target_step"] = np.asarray(
        jax.random.uniform(jax.random.key(4), (64, 64, 3)))
    scene, target = train_fixture()
    inp["scene_train"], inp["target_train"] = np_scene(scene), np.asarray(
        target)
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_jit")
    return multihost.launch(torch_rank_bodies.parallel_jit_world, WORLD,
                            (WORLD, inputs, str(out)), backend="gloo",
                            out_dir=str(out), device="cpu",
                            timeout_s=TIMEOUT_S)


def fake_mesh(backend, distributed=True, device="cpu"):
    return Mesh(("tiles",), (2,), (0,), (None,), torch.device(device),
                distributed, backend)


def test_backend_decides_the_route():
    """A body on a CUDA device is captured alone, on a one-process mesh or
    on an NCCL mesh, and runs eagerly on a gloo mesh (its collectives wait
    on the host) and on the CPU: decided from the backend, no process
    group needed."""
    cuda = torch.device("cuda", 0)
    assert graphs.captures_on(cuda)
    assert graphs.captures_on(cuda, fake_mesh("nccl"))
    assert graphs.captures_on(cuda, fake_mesh(None, distributed=False))
    assert not graphs.captures_on(cuda, fake_mesh("gloo"))
    cpu = torch.device("cpu")
    assert not graphs.captures_on(cpu)
    assert not graphs.captures_on(cpu, fake_mesh("nccl"))


def test_mesh_keys_hold_no_address_and_no_weak_key():
    """On a mesh an entry's key is the static key and the shapes: a new
    input at another address is the same entry and is read anew (copied),
    a dropped input evicts nothing, only the LRU bound does, in call order;
    nothing may be held."""
    mesh = fake_mesh(None, distributed=False)
    cache = graphs.Captured("mesh_keys")

    def body(x):
        return x * 2

    a, b = torch.ones(4), torch.full((4,), 3.0)
    assert cache("k", [a], body, mesh=mesh).tolist() == [2.0] * 4
    assert cache("k", [b], body, mesh=mesh).tolist() == [6.0] * 4
    assert len(cache.entries) == 1
    (entry,) = cache.entries.values()
    assert entry.buffers[0].data_ptr() not in (a.data_ptr(), b.data_ptr())
    del a, b
    gc.collect()
    assert len(cache.entries) == 1
    for key in ("j", "k", "l", "m", "n"):
        cache(key, [torch.ones(4)], body, mesh=mesh)
    assert [k[0] for k in cache.entries] == ["k", "l", "m", "n"]
    with pytest.raises(ValueError, match="held"):
        cache("k", [torch.ones(4)], body, held=1, mesh=mesh)


def test_ranks_must_agree_on_a_missed_key(ranks):
    """Two ranks that miss on the same key pass the check and run; a key
    that differs raises on both ranks before the body runs."""
    for r in ranks:
        agree = r["agreement"]
        assert agree["agreed"] == [2.0, 2.0, 2.0]
        assert "ranks disagree" in agree["disagreed"]
        assert not agree["body_ran"]


@pytest.mark.parametrize("case", ["tile_f32", "tile_p16", "gauss_f32",
                                  "gauss_p16"])
def test_jit_renders_equal_the_eager_ones(case, ranks):
    """Two cameras in turn, twice: every frame of render_tile_sharded_jit
    and render_gaussian_sharded_jit bit-identical to the eager function's
    on the same rank, and alike on both ranks."""
    for r in ranks:
        assert all(r[case]["same"]), r[case]["same"]
    for a, b in zip(ranks[0][case]["frames"], ranks[1][case]["frames"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["tile_f32", "tile_p16", "gauss_f32"])
def test_jit_renders_match_jax(case, ranks):
    """The frames against the JAX package's sharded renders, within rtol
    1e-4 / atol 1e-5 (1e-6 on T)."""
    kind, fmt = case.split("_")
    cfg = CFG if fmt == "f32" else dataclasses.replace(
        CFG, binning="tiered", stream_format="packed16")
    scene = jax_scene(0, 240, 2)
    if kind == "tile":
        mesh = jax_mesh({"tiles": WORLD})
        fn = jax.jit(lambda s, c: jax_tile_sharded(s, c, cfg, mesh))
    else:
        mesh = jax_mesh({"gauss": WORLD})
        fn = jax.jit(lambda s, c: jax_gauss(s, c, cfg, mesh))
    for cam, got in zip(two_views(), ranks[0][case]["frames"]):
        img, trans, ovf = fn(scene, cam)
        assert not got[2] and not bool(ovf)
        np.testing.assert_allclose(got[0], np.asarray(img), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1], np.asarray(trans), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["tile_steps", "gauss_steps"])
def test_steps_equal_their_eager_bodies_and_keep_storage(case, ranks):
    """Three steps of the step through its cache (eager on gloo) against
    three of its eager body from a copy of the scene: every output and the
    final scene bit for bit, one entry (the SH degree's mask an input of
    it); each gradient's and the tap's storage kept across steps, the
    precondition of a capture."""
    for r in ranks:
        got = r[case]
        assert all(got["same"]) and got["scene_same"]
        assert got["grad_ptrs_kept"] and got["tap_ptr_kept"]
        assert got["entries"] == 1
        assert not got["first"]["overflow"]


def test_tile_sharded_step_matches_jax(ranks, inputs):
    """The tile-sharded step's first call (SH degree 0) against the JAX
    sharded step on a data-1 x tiles-2 mesh: the loss within 1e-5, the tap
    gradients within rtol 2e-3 / atol 2e-6, visibility equal, the updated
    scene within rtol 2e-3 / atol 2e-5 (after three steps on the port's
    side: checked against JAX's third)."""
    mesh = jax_mesh({"data": 1, "tiles": WORLD})
    scene = jax_scene(3, 150, 1)
    opt = jax_optimizer(lr=1e-2)
    step = jax_step(CFG, mesh, opt, ssim_weight=0.2)
    cam = JaxCamera.default(64, 64)
    cams = jax.tree.map(lambda x: x[None], cam)
    target = jnp.asarray(inputs["target_step"])
    padded = jnp.pad(target, ((0, CFG.padded_height - 64),
                              (0, CFG.padded_width - 64), (0, 0)))[None]
    cams_s, targets_s = jax_shard_batch(cams, padded, mesh)
    state = init_train_state(scene, opt)
    state, loss, _, (tap, vis) = step(state, cams_s, targets_s, 0)
    first = ranks[0]["tile_steps"]["first"]
    assert abs(first["loss"] - float(loss)) < 1e-5
    np.testing.assert_allclose(first["tap"], np.asarray(tap), rtol=2e-3,
                               atol=2e-6)
    np.testing.assert_array_equal(first["visible"], np.asarray(vis))
    for d in (1, 1):
        state, _, _, _ = step(state, cams_s, targets_s, d)
    for r in ranks:
        for f in FIELDS:
            np.testing.assert_allclose(
                r["tile_steps"]["scene"][f], np.asarray(getattr(state.scene,
                                                                f)),
                rtol=2e-3, atol=2e-5, err_msg=f)


def test_gaussian_sharded_step_matches_jax(ranks):
    """The Gaussian-sharded step's first call against JAX's N-sharded step
    on a gauss-2 mesh: the loss within 1e-5, the shards' tap gradients
    within rtol 2e-3 / atol 2e-6, visibility equal; the shards' scene after
    three steps against JAX's third within rtol 2e-3 / atol 2e-5."""
    mesh = jax_mesh({"gauss": WORLD})
    scene, target = train_fixture()
    opt = jax_optimizer(lr=1e-2)
    step = jax_gstep(CFG, mesh, opt, scene, ssim_weight=0.2)
    st = jax_shard_state(
        TrainState(scene, opt.init(scene), jnp.zeros((), jnp.int32)), mesh)
    cams = jax.tree.map(lambda x: x[None], JaxCamera.default(64, 64))
    st, m, (sg, vis) = step(st, cams, target[None])
    got = [r["gauss_steps"]["first"] for r in ranks]
    for g in got:
        assert abs(g["loss"] - float(m["loss"])) < 1e-5
    np.testing.assert_allclose(np.concatenate([g["tap"] for g in got]),
                               np.asarray(sg), rtol=2e-3, atol=2e-6)
    np.testing.assert_array_equal(
        np.concatenate([g["visible"] for g in got]), np.asarray(vis))
    for _ in range(2):
        st, _, _ = step(st, cams, target[None])
    for f in FIELDS:
        np.testing.assert_allclose(
            np.concatenate([r["gauss_steps"]["scene"][f] for r in ranks]),
            np.asarray(getattr(st.scene, f)), rtol=2e-3, atol=2e-5,
            err_msg=f)


def test_gaussian_sharded_densify_equals_its_eager_body(ranks):
    """The densify program through its cache, twice, against its eager
    body on the same shard and state: scene, fresh state, changed and the
    summed stats bit for bit, one entry, the stats alike on both ranks and
    a round that split or cloned."""
    for r in ranks:
        assert all(r["gauss_steps"]["densify_same"])
        assert r["gauss_steps"]["densify_entries"] == 1
    stats = [r["gauss_steps"]["densify_stats"] for r in ranks]
    assert stats[0] == stats[1]
    assert stats[0]["num_split"] + stats[0]["num_clone"] > 0


def test_densify_and_prune_jit_equals_eager_and_jax(monkeypatch):
    """The captured single-device round (eager on the CPU, through the
    cache) equals `densify_and_prune` bit for bit and JAX's jitted
    `densify_and_prune` on the same numpy inputs (the scene within rtol
    1e-6, the masks and counts equal); the scene is read where it lies."""
    monkeypatch.setattr(densify, "DENSIFY_GRAPHS", graphs.Captured("densify"))
    jscene = jax_scene(9, 200, 1).pad_to(256)
    rng = np.random.default_rng(0)
    grad = rng.uniform(0, 1e-3, 256).astype(np.float32)
    visits = rng.integers(0, 5, 256).astype(np.int32)
    jstate = jax_densify.DensifyState(jnp.asarray(grad),
                                      jnp.asarray(4, jnp.int32),
                                      jnp.asarray(visits))
    kw = dict(grad_threshold=1e-4, max_world_scale=0.5)
    jout = jax.jit(lambda s, st: jax_densify.densify_and_prune(s, st, **kw))(
        jscene, jstate)
    scene = scene_from_numpy(**np_scene(jscene), device="cpu")
    state = densify.DensifyState(torch.from_numpy(grad),
                                 torch.tensor(4, dtype=torch.int32),
                                 torch.from_numpy(visits))
    got = densify.densify_and_prune_jit(scene, state, **kw)
    again = densify.densify_and_prune_jit(scene, state, **kw)
    want = densify.densify_and_prune(scene, state, **kw)
    assert len(densify.DENSIFY_GRAPHS.entries) == 1
    (entry,) = densify.DENSIFY_GRAPHS.entries.values()
    assert len(entry.buffers) == 3  # the state; the scene is held
    for out in (got, again):
        assert torch_rank_bodies._bits_equal(out, want)
    new, fresh, changed, stats = got
    jnew, jfresh, jchanged, jstats = jout
    np.testing.assert_array_equal(changed.numpy(), np.asarray(jchanged))
    for f in FIELDS:
        np.testing.assert_allclose(scene_to_numpy(new)[f],
                                   np.asarray(getattr(jnew, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in jstats.items()}
    assert int(stats["num_split"]) + int(stats["num_clone"]) > 0
    np.testing.assert_array_equal(fresh.grad_accum.numpy(),
                                  np.asarray(jfresh.grad_accum))
