"""The one binding and launch seam of the port's CUDA kernels
(`ops/cuda/_build.py`): against a stand-in library here, and against the
entry points `csrc/*.cu` declares."""

import contextlib
import ctypes
import functools
import re
import types

import pytest
import torch

from gsplat_tpu_torch.ops.cuda import _build, counters

STREAM = 0xBEEF


class _Entry:
    """A C entry point's stand-in: returns `codes` in turn, keeps its calls
    and the argument types set on it."""

    def __init__(self, codes):
        self.codes, self.calls = list(codes), []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.codes.pop(0)


class _Lib:
    """A loaded library's stand-in that counts its symbol look-ups."""

    def __init__(self, **entries):
        self.entries, self.lookups = entries, 0

    def __getattr__(self, name):
        if name.startswith("gsplat_"):
            self.lookups += 1
            return self.entries[name]
        raise AttributeError(name)


@pytest.fixture
def fake(monkeypatch):
    """A stand-in library "fake", an empty binding table, and a CUDA device
    context and stream that need no card."""
    lib = _Lib(gsplat_fake=_Entry([0, 0, 0, 7, 0, 0]),
               gsplat_fake_query=_Entry([32]))
    monkeypatch.setitem(_build._libs, "fake", lib)
    monkeypatch.setattr(_build, "bound", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(
                            cuda_stream=STREAM))
    before = counters.snapshot()
    yield lib
    counters.add(counters.rise(before, counters.snapshot()), -1)


def test_kernel_binds_once_passes_the_stream_last_checks_and_counts(fake):
    launch = _build.kernel("fake", "gsplat_fake", [_build.PTR, _build.INT],
                           "P3")
    entry = fake.entries["gsplat_fake"]
    assert fake.lookups == 0  # nothing is loaded before the first launch
    before = counters.snapshot()
    for i in range(3):
        launch("cuda:0", 100 + i, i)
    assert fake.lookups == 1
    assert entry.argtypes == [_build.PTR, _build.INT, _build.PTR]
    assert entry.restype is ctypes.c_int
    assert entry.calls == [(100 + i, i, STREAM) for i in range(3)]
    assert counters.rise(before, counters.snapshot()) == {"P3": 3}
    # A nonzero code raises, naming the entry point, and counts nothing.
    with pytest.raises(RuntimeError, match="gsplat_fake failed.*cudaError 7"):
        launch("cuda:0", 1, 2)
    assert counters.rise(before, counters.snapshot()) == {"P3": 3}
    # A launch counts under the name it is given, or nowhere with None.
    launch("cuda:0", 1, 2, count="P4")
    launch("cuda:0", 1, 2, count=None)
    assert counters.rise(before, counters.snapshot()) == {"P3": 3, "P4": 1}
    assert fake.lookups == 1 and len(entry.calls) == 6
    with pytest.raises(ValueError, match="bound already"):
        _build.kernel("fake", "gsplat_fake", [], None)


def test_a_library_put_in_place_of_another_is_bound_anew(fake, monkeypatch):
    launch = _build.kernel("fake", "gsplat_fake", [_build.INT], None)
    launch("cuda:0", 1)
    other = _Lib(gsplat_fake=_Entry([0, 0]))
    monkeypatch.setitem(_build._libs, "fake", other)
    launch("cuda:0", 2)
    launch("cuda:0", 3)
    assert (fake.lookups, other.lookups) == (1, 1)
    assert other.entries["gsplat_fake"].calls == [(2, STREAM), (3, STREAM)]
    assert other.entries["gsplat_fake"].argtypes == [_build.INT, _build.PTR]


def test_query_takes_no_stream_and_counts_nothing(fake):
    pixels = _build.query("fake", "gsplat_fake_query")
    before = counters.snapshot()
    assert pixels() == 32
    entry = fake.entries["gsplat_fake_query"]
    assert entry.calls == [()] and entry.argtypes == []
    assert counters.rise(before, counters.snapshot()) == {}


def test_every_entry_point_is_bound_once_with_its_arity():
    """The bound symbols are the `extern "C"` entry points of csrc/*.cu,
    each bound once, from its own source, with as many argument types as
    it declares parameters."""
    import gsplat_tpu_torch.ops.cuda.cull  # noqa: F401
    import gsplat_tpu_torch.ops.cuda.features  # noqa: F401
    import gsplat_tpu_torch.ops.cuda.probes  # noqa: F401
    import gsplat_tpu_torch.ops.cuda.project  # noqa: F401
    import gsplat_tpu_torch.ops.cuda.raster  # noqa: F401
    import gsplat_tpu_torch.ops.cuda.segsum  # noqa: F401
    import gsplat_tpu_torch.utils.trace  # noqa: F401

    declared = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern\s+"C"\s+int\s+(gsplat_\w+)\s*\(([^)]*)\)',
                src.read_text()):
            assert name not in declared, f"{name} declared twice"
            declared[name] = (src.stem,
                              len(params.split(",")) if params.strip() else 0)
    assert len(declared) >= 18
    assert {name: (lib, len(types)) for name, (lib, types)
            in _build.bound.items()} == declared


CPU = torch.device("cpu")


@pytest.mark.parametrize("shape,dtype,strided,device,match", [
    ((3, 4), torch.float64, False, None, "float32, got torch.float64"),
    ((3, 4, 1), torch.float32, False, None,
     r"shape \(3, None\) \(None: any size\), got \(3, 4, 1\)"),
    ((2, 4), torch.float32, False, None, r"shape \(3, None\).*got \(2, 4\)"),
    ((3, 4), torch.float32, True, None, "contiguous, got strides"),
    ((3, 4), torch.float32, False, None, "on a CUDA device.*got cpu"),
    ((3, 4), torch.float32, False, torch.device("meta"), "on meta, got cpu"),
    ((3, 4), torch.float32, False, CPU, None),
])
def test_expect_names_the_argument_the_want_and_the_got(shape, dtype,
                                                       strided, device,
                                                       match):
    t = torch.zeros(shape[::-1], dtype=dtype).t() if strided else \
        torch.zeros(shape, dtype=dtype)
    check = functools.partial(_build.expect, t, "k: x", dtype=torch.float32,
                              shape=(3, None), device=device)
    if match is None:
        check()
        return
    with pytest.raises(ValueError, match=f"k: x must .*{match}"):
        check()
