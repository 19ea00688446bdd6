"""The port's demo (`gsplat_tpu_torch.fit_demo`) against
`examples/fit_demo.py` (CPU): the same render config and fit arguments for
the same flags, with both packages' `fit` recording their call; and a
short real run."""

import dataclasses
import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import gsplat_tpu  # noqa: E402
import gsplat_tpu.train.loop as jax_loop  # noqa: E402
import gsplat_tpu_torch.train.loop as port_loop  # noqa: E402
from gsplat_tpu_torch import fit_demo  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The JAX demo renders its init and its result outside jit; the same
# function jitted gives the same images and skips op-by-op dispatch.
JAX_RENDER = jax.jit(gsplat_tpu.render, static_argnums=2)


@pytest.fixture(scope="module")
def jax_demo():
    """examples/fit_demo.py as a module (a script, not in a package)."""
    spec = importlib.util.spec_from_file_location(
        "fit_demo_jax", ROOT / "examples" / "fit_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(calls):
    def fit(scene, cameras, targets, cfg, **kw):
        calls.append((cfg, kw, int(targets.shape[0]), scene.num_gaussians))
        return scene, []
    return fit


@pytest.mark.parametrize("flags", [
    [],
    ["--fast", "--stream-format", "packed4"],
], ids=" ".join)
def test_demo_config_and_fit_arguments_match_jax(jax_demo, flags, tmp_path,
                                                 monkeypatch, capsys):
    small = ["--steps", "20", "--n", "150", "--views", "2", "--size", "32",
             "--out-dir", str(tmp_path), *flags]
    want, got = [], []
    monkeypatch.setattr(jax_loop, "fit", _recorder(want))
    monkeypatch.setattr(gsplat_tpu, "render", JAX_RENDER)
    monkeypatch.setattr(sys, "argv", ["fit_demo.py", *small])
    jax_demo.main()
    jax_out = capsys.readouterr().out
    monkeypatch.setattr(port_loop, "fit", _recorder(got))
    fit_demo.main([*small, "--device", "cpu"])
    port_out = capsys.readouterr().out
    (jcfg, jkw, jviews, jn), = want
    (cfg, kw, views, n), = got
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert kw.keys() == jkw.keys()
    for k, v in jkw.items():
        if k == "densify_max_scale":  # 0.05 x the target's orbit radius
            assert 0.0 < kw[k] < 10.0 * v and 0.0 < v < 10.0 * kw[k]
        else:
            assert kw[k] == v, k
    assert (views, n) == (jviews, jn) == (2, 300)
    # The same report line, with a PSNR of the unfitted init.
    for out in (jax_out, port_out):
        assert out.splitlines()[0].startswith("view-0 PSNR after 20 steps: ")
        assert out.splitlines()[0].endswith(" dB")


def test_demo_short_run(tmp_path, capsys):
    """20 steps at 48x48 on the CPU, packed16 with --fast: finite PSNR, its
    files written, the loss logged."""
    res = fit_demo.main(["--steps", "20", "--n", "200", "--views", "2",
                         "--size", "48", "--fast", "--stream-format",
                         "packed16", "--out-dir", str(tmp_path),
                         "--device", "cpu"])
    assert np.isfinite(res["psnr"]) and np.isfinite(res["initial_psnr"])
    assert [m["step"] for m in res["metrics"]] == [20]
    for name in ("target.png", "initial.png", "fitted.png", "metrics.csv"):
        assert os.path.exists(tmp_path / name), name
    assert "view-0 PSNR after 20 steps:" in capsys.readouterr().out
