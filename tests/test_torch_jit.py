"""The port's counterparts of `jax.jit` (CPU): `render_jit`,
`render_loss_and_grad` and the train step go through `utils/graphs.py`,
which on a CUDA device captures a CUDA graph per static key and on the CPU
runs the same copy-in, body and copy-out eagerly. Held here against the JAX
package's jitted functions, and for the cache's keys, its bound, the
freshness of its outputs, the device-side learning-rate schedule of the
capturable Adam, and `fit`'s in-place state."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.ops.camera import look_at as jax_look_at  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_make_optimizer  # noqa: E402
from gsplat_tpu.render.pipeline import render_jit as jax_render_jit  # noqa: E402
from gsplat_tpu.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from gsplat_tpu_torch import RenderConfig, render, render_jit  # noqa: E402
from gsplat_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.render import pipeline  # noqa: E402
from gsplat_tpu_torch.train import loop  # noqa: E402
from gsplat_tpu_torch.utils import graphs  # noqa: E402
from gsplat_tpu_torch.utils.checkpoint import set_adam_state  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          binning="tiered", tier_spec=(8, 5, 16),
          gather_backward="variadic", grad_readout="f32",
          segment_sum="pallas", stream_format="f32")
# Images: the render tolerance of the port's render tests.
IMG_RTOL, IMG_ATOL = 1e-4, 1e-5
# Scene gradients and steps: the tolerance of tests/test_pallas.py:83-85.
RTOL, ATOL = 5e-3, 1e-5


def two_views():
    cams = [JaxCamera.default(64, 64)]
    eye = np.asarray(cams[0].cam_pos, np.float64)
    view = jax_look_at(eye + [0.1, 0.0, 0.0], eye + [0.15, 0.0, 1.0],
                       up=(0.0, -1.0, 0.0))
    cams.append(JaxCamera.create(view, 64, 64, fx=64.0, fy=64.0, znear=0.2,
                                 zfar=10.0))
    return cams


def port_scene(jscene):
    return scene_from_numpy(*(np.asarray(getattr(jscene, f))
                              for f in SCENE_FIELDS), device="cpu")


def port_camera(jcam):
    return camera_from_numpy(*(np.asarray(getattr(jcam, f))
                               for f in CAM_FIELDS), device="cpu")


@pytest.fixture
def fresh_caches(monkeypatch):
    """Empty render and loss-and-gradient caches for one test (other test
    files of the worker fill the module's own)."""
    monkeypatch.setattr(pipeline, "RENDER_GRAPHS", graphs.Captured("render"))
    monkeypatch.setattr(pipeline, "LOSS_AND_GRAD_GRAPHS",
                        graphs.Captured("loss_and_grad"))


def test_render_jit_matches_jax_for_two_cameras_in_turn(fresh_caches):
    """Two cameras through one cached entry, one after the other: each
    image is its own camera's JAX `render_jit` image, the second not the
    first's."""
    jscene = jax_random_scene(jax.random.key(0), 200, sh_degree=1)
    jcams = two_views()
    jcfg = JaxConfig(**KW, impl="jnp")
    cfg = RenderConfig(**KW)
    scene = port_scene(jscene)
    outs = [render_jit(scene, port_camera(c), cfg) for c in jcams]
    want = [jax_render_jit(jscene, c, jcfg) for c in jcams]
    for out, w in zip(outs, want):
        np.testing.assert_allclose(out.image.numpy(), np.asarray(w.image),
                                   rtol=IMG_RTOL, atol=IMG_ATOL)
        np.testing.assert_allclose(out.transmittance.numpy(),
                                   np.asarray(w.transmittance),
                                   rtol=IMG_RTOL, atol=IMG_ATOL)
        assert int(out.num_intersections) == int(w.num_intersections)
        assert not bool(out.overflow)
    differ = np.abs(outs[1].image.numpy() - np.asarray(want[0].image))
    assert differ.max() > 100 * IMG_ATOL
    assert len(pipeline.RENDER_GRAPHS.entries) == 1


def test_render_jit_keys_on_config_and_reads_a_new_scene(fresh_caches):
    """The same cfg and shapes share one entry, another max_intersections
    makes a second; a new scene object with other storage is read, not the
    one the first entry was made with: the scene's addresses are part of
    the key, so it is an entry of its own."""
    cfg = RenderConfig(**KW)
    cam = port_camera(JaxCamera.default(64, 64))
    a = port_scene(jax_random_scene(jax.random.key(1), 150, sh_degree=1))
    b = port_scene(jax_random_scene(jax.random.key(2), 150, sh_degree=1))
    img_a = render_jit(a, cam, cfg).image
    render_jit(a, cam, cfg)
    assert len(pipeline.RENDER_GRAPHS.entries) == 1
    img_b = render_jit(b, cam, cfg).image
    assert len(pipeline.RENDER_GRAPHS.entries) == 2
    with torch.no_grad():
        np.testing.assert_array_equal(img_b.numpy(),
                                      render(b, cam, cfg).image.numpy())
    assert not torch.equal(img_a, img_b)
    # The first scene again, after the second: its own entry, read anew.
    np.testing.assert_array_equal(render_jit(a, cam, cfg).image.numpy(),
                                  img_a.numpy())
    # A scene of other tensors at the same addresses (fit's detached view
    # of its parameters) is the same entry.
    same = dataclasses.replace(a, **{f: getattr(a, f).detach()
                                     for f in SCENE_FIELDS})
    render_jit(same, cam, cfg)
    assert len(pipeline.RENDER_GRAPHS.entries) == 2
    other = dataclasses.replace(cfg, max_intersections=(1 << 13) + 128)
    render_jit(a, cam, other)
    assert len(pipeline.RENDER_GRAPHS.entries) == 3


def test_scene_is_read_where_it_lies_and_never_written(fresh_caches):
    """A served scene is read where it lies (no copy, no buffer of the
    cache's), and what the next call reads after an in-place update; a new
    scene object never writes into the first scene. A caller that keeps
    frame t does not see it change with frame t + 1 (outputs are copies,
    as jax.jit returns new arrays)."""
    cfg = RenderConfig(**KW)
    cam = port_camera(JaxCamera.default(64, 64))
    a = port_scene(jax_random_scene(jax.random.key(3), 150, sh_degree=1))
    b = port_scene(jax_random_scene(jax.random.key(4), 150, sh_degree=1))
    kept = {f: getattr(a, f).clone() for f in SCENE_FIELDS}
    first = render_jit(a, cam, cfg)
    img0 = first.image.clone()
    (entry,) = pipeline.RENDER_GRAPHS.entries.values()
    # Buffers of the camera's seven fields alone.
    assert len(entry.buffers) == 7
    ptrs = {t.data_ptr() for t in entry.buffers}
    assert not ptrs & {getattr(a, f).data_ptr() for f in SCENE_FIELDS}
    with torch.no_grad():
        a.means += 0.05
        np.testing.assert_array_equal(render_jit(a, cam, cfg).image.numpy(),
                                      render(a, cam, cfg).image.numpy())
        a.means.copy_(kept["means"])
    assert len(pipeline.RENDER_GRAPHS.entries) == 1
    np.testing.assert_array_equal(first.image.numpy(), img0.numpy())
    with torch.no_grad():
        np.testing.assert_array_equal(render_jit(b, cam, cfg).image.numpy(),
                                      render(b, cam, cfg).image.numpy())
    for f in SCENE_FIELDS:
        assert torch.equal(getattr(a, f), kept[f]), f
    np.testing.assert_array_equal(render_jit(a, cam, cfg).image.numpy(),
                                  img0.numpy())
    assert first.image.data_ptr() not in ptrs | {
        render_jit(a, cam, cfg).image.data_ptr()}


def test_a_dropped_scene_takes_its_entries_with_it(fresh_caches):
    """The cache holds no reference to a served scene: once the caller drops
    it, its storage is freed and the entries that read it go (on a card,
    their graphs with them); a scene still served keeps its entry."""
    import gc

    cfg = RenderConfig(**KW)
    cam = port_camera(JaxCamera.default(64, 64))
    a = port_scene(jax_random_scene(jax.random.key(5), 150, sh_degree=1))
    b = port_scene(jax_random_scene(jax.random.key(6), 150, sh_degree=1))
    for scene in (a, b):
        render_jit(scene, cam, cfg)
        pipeline.render_loss_and_grad(scene, cam, torch.zeros(64, 64, 3), cfg)
    assert len(pipeline.RENDER_GRAPHS.entries) == 2
    assert len(pipeline.LOSS_AND_GRAD_GRAPHS.entries) == 2
    del scene
    views = [getattr(b, f).detach() for f in SCENE_FIELDS]
    del b
    gc.collect()
    # b's tensors live on in `views`: its entries stay until they go too.
    assert len(pipeline.RENDER_GRAPHS.entries) == 2
    del views[1]
    gc.collect()
    assert len(pipeline.RENDER_GRAPHS.entries) == 1
    assert len(pipeline.LOSS_AND_GRAD_GRAPHS.entries) == 1
    render_jit(a, cam, cfg)
    assert len(pipeline.RENDER_GRAPHS.entries) == 1


def test_captured_keeps_at_most_max_entries_least_recent_first(monkeypatch):
    """The cache is bounded: past MAX_ENTRIES the least recently used key
    goes, and a key used again moves to the back."""
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 2)
    cache = graphs.Captured("test")

    def body(x):
        return x * 2

    x = torch.ones(3)
    for key in ("a", "b", "a", "c"):
        np.testing.assert_array_equal(cache(key, [x], body).numpy(),
                                      [2.0, 2.0, 2.0])
    assert [k[0] for k in cache.entries] == ["a", "c"]
    # Other shapes are another entry of the same static key.
    cache("c", [torch.ones(4)], body)
    assert [(k[0], k[2][0][0]) for k in cache.entries] == [("c", (3,)),
                                                           ("c", (4,))]
    with pytest.raises(ValueError, match="one device"):
        cache("d", [x, torch.empty(2, device="meta")], body)


def test_launch_counter_registry_reads_rises_and_adds():
    """`ops/cuda/counters.py` holds every launch count by the kernel
    table's names; a rise read across a call is what a replay adds back,
    and a name outside the table is refused."""
    from gsplat_tpu_torch.ops.cuda import counters

    before = counters.snapshot()
    assert set(before) == {
        "K1", "K1.packed", "K2", "K2.packed", "K3.mask", "K3.compact",
        "K3.rank", "K3.count", "K3.emit", "K4", "K5", "K6", "K7",
        "K7.chunked", "K8", "K9", "K10", "K11", "K12", "K13", "P1", "P2",
        "P3", "P4", "mark", "collectives"}
    assert counters.rise(before, counters.snapshot()) == {}
    try:
        counters.bump("K2", 2)
        counters.bump("K5")
        rose = counters.rise(before, counters.snapshot())
        assert rose == {"K2": 2, "K5": 1}
        counters.add(rose, 3)
        now = counters.snapshot()
        assert (now["K2"], now["K5"]) == (before["K2"] + 8, before["K5"] + 4)
        with pytest.raises(KeyError, match="raster.bwd_launches"):
            counters.bump("raster.bwd_launches")
    finally:
        counters.add(counters.rise(before, counters.snapshot()), -1)
    assert counters.snapshot() == before


def test_render_loss_and_grad_goes_through_one_entry_per_config(
        fresh_caches):
    """`render_loss_and_grad` runs through the cache (one entry for one
    cfg and shapes), equal to the eager loss and gradients, and writes no
    `.grad` on the caller's scene."""
    cfg = RenderConfig(**KW)
    jcams = two_views()
    scene = port_scene(jax_random_scene(jax.random.key(4), 150,
                                        sh_degree=1))
    for f in SCENE_FIELDS:
        getattr(scene, f).requires_grad_(True)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(64, 64, 3)).astype(np.float32))
    for jcam in jcams:
        cam = port_camera(jcam)
        loss, grads = pipeline.render_loss_and_grad(scene, cam, target, cfg)
        want_loss, want = pipeline._loss_and_grad(scene, cam, target, cfg)
        assert float(loss) == float(want_loss)
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(getattr(grads, f).numpy(),
                                          getattr(want, f).numpy())
    assert len(pipeline.LOSS_AND_GRAD_GRAPHS.entries) == 1
    assert all(getattr(scene, f).grad is None for f in SCENE_FIELDS)


@pytest.mark.parametrize("ratio", [0.01, 4.0])
def test_tensor_lr_schedule_matches_host_and_optax(ratio):
    """The capturable Adam's device-side "means" rate (`decayed_lr` of a
    float64 count) equals the host schedule `means_lr_at(t)` and optax's
    `exponential_decay` for t = 0..12, past lr_max_steps = 8 where the rate
    holds its end value."""
    scene = port_scene(jax_random_scene(jax.random.key(5), 10, sh_degree=0))
    opt = loop.make_optimizer(scene, 1e-2, position_lr_final_ratio=ratio,
                              lr_max_steps=8)
    base = 1e-2 * loop.LR_SCALES["means"]
    sched = optax.exponential_decay(init_value=base, transition_steps=8,
                                    decay_rate=ratio, end_value=base * ratio)
    for t in range(13):
        dev = float(loop.decayed_lr(torch.tensor(float(t), dtype=torch.float64),
                                    *opt.decay))
        np.testing.assert_allclose(dev, opt.means_lr_at(t), rtol=1e-12)
        np.testing.assert_allclose(dev, float(sched(t)), rtol=1e-6)
    # The rate the host-count (CPU) optimizer sets before each update.
    seen = []
    for t in range(4):
        for f in SCENE_FIELDS:
            getattr(scene, f).grad = torch.zeros_like(getattr(scene, f))
        opt.step()
        seen.append(opt.param_groups[0]["lr"])
    assert opt.updates == 4
    np.testing.assert_allclose(seen, [opt.means_lr_at(t) for t in range(4)],
                               rtol=1e-15)


def test_wrapped_step_four_steps_with_decay_match_jax():
    """Four steps of `make_train_step` (the wrapped step) with the
    position-lr decay and the SH degree raised between steps, against the
    JAX step with `make_optimizer(position_lr_final_ratio, lr_max_steps)`:
    the losses each step and the updated scene within rtol 5e-3 / atol
    1e-5; every degree goes through one key, its mask an input."""
    jscene = jax_random_scene(jax.random.key(0), 150, sh_degree=1)
    jcams = two_views()
    rng = np.random.default_rng(7)
    targets = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    degrees = (0, 0, 1, 1)
    decay = dict(position_lr_final_ratio=0.1, lr_max_steps=3)
    jcfg = JaxConfig(**KW, impl="jnp")
    jopt = jax_make_optimizer(1e-2, **decay)
    jstep = jax_make_train_step(jcfg, jopt, ssim_weight=0.2)
    jstate = init_train_state(jscene, jopt)
    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs), *jcams)
    jlosses = []
    for d in degrees:
        jstate, jl, _, _ = jstep(jstate, jbatch, jnp.asarray(targets), d)
        jlosses.append(float(jl))

    scene = port_scene(jscene)
    cams = [port_camera(c) for c in jcams]
    opt = loop.make_optimizer(scene, 1e-2, **decay)
    step = loop.make_train_step(RenderConfig(**KW), opt, ssim_weight=0.2)
    losses = []
    for d in degrees:
        loss, aux, _ = step(scene, cams, torch.from_numpy(targets), d)
        assert bool(aux["grads_finite"]) and not bool(aux["overflow"])
        losses.append(float(loss))
    assert len(step.graphs.entries) == 1
    assert opt.updates == 4
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    got = scene_to_numpy(scene)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(jstate.scene, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def _state_ptrs(opt):
    out = {}
    for group in opt.param_groups:
        p = group["params"][0]
        out[group["name"]] = (p.data_ptr(), p.grad.data_ptr(),
                              *(opt.state[p][k].data_ptr()
                                for k in ("exp_avg", "exp_avg_sq", "step")))
    return out


def test_fit_keeps_its_state_in_place_and_equals_the_eager_fit(monkeypatch):
    """`fit` with a densify round and an opacity reset: every parameter,
    `.grad` and Adam state tensor keeps its storage from the first step on
    (a captured step reads and writes them there), and the rows and the
    trained scene equal those of the same fit on the eager step."""
    jcams = two_views()
    target = port_scene(jax_random_scene(jax.random.key(1), 120,
                                         sh_degree=1))
    cams = [port_camera(c) for c in jcams]
    cfg = RenderConfig(**KW)
    with torch.no_grad():
        targets = torch.stack([render(target, c, cfg).image for c in cams])
    init = port_scene(jax_random_scene(jax.random.key(2), 100, sh_degree=1))
    init.opacity_logits = torch.full((100,), 1.0)
    init = init.pad_to(160)
    run = dict(steps=6, lr=1e-2, ssim_weight=0.2, seed=3, log_every=1,
               densify_every=2, densify_from=2, densify_until=4,
               densify_grad_threshold=1e-4, opacity_reset_every=3,
               sh_warmup_every=2, position_lr_final_ratio=0.1)

    made = []
    make_optimizer = loop.make_optimizer

    def recording(*a, **k):
        made.append(make_optimizer(*a, **k))
        return made[-1]

    monkeypatch.setattr(loop, "make_optimizer", recording)
    ptrs = []
    trained, rows = loop.fit(init, cams, targets, cfg,
                             on_metrics=lambda row: ptrs.append(
                                 _state_ptrs(made[-1])) or row, **run)
    assert len(ptrs) == 6 and all(p == ptrs[0] for p in ptrs)

    monkeypatch.setattr(loop, "make_train_step", loop.make_eager_train_step)
    eager, erows = loop.fit(init, cams, targets, cfg, **run)
    assert [{k: v for k, v in r.items() if k != "it_per_s"} for r in rows] \
        == [{k: v for k, v in r.items() if k != "it_per_s"} for r in erows]
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(trained, f).numpy(),
                                      getattr(eager, f).numpy(), err_msg=f)


def test_set_adam_state_writes_an_existing_state_in_place():
    """A checkpoint restored into an optimizer that has stepped writes its
    moments and step count where they lie (a captured step goes on reading
    them); a fresh state is made where torch makes it."""
    scene = port_scene(jax_random_scene(jax.random.key(6), 20, sh_degree=0))
    opt = loop.make_optimizer(scene, 1e-2)
    p = opt.param_groups[0]["params"][0]
    set_adam_state(opt, p, np.ones(p.shape, np.float32),
                   np.full(p.shape, 2.0, np.float32), 3.0)
    st = opt.state[p]
    assert st["step"].device.type == "cpu" and float(st["step"]) == 3.0
    before = {k: st[k].data_ptr() for k in ("exp_avg", "exp_avg_sq", "step")}
    set_adam_state(opt, p, np.zeros(p.shape, np.float32),
                   np.full(p.shape, 5.0, np.float32), 7.0)
    assert {k: st[k].data_ptr() for k in before} == before
    assert float(st["step"]) == 7.0 and float(st["exp_avg_sq"][0, 0]) == 5.0
