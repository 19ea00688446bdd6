"""The tiny cells of the CPU tests: the benchmark's configurations cut to
a few hundred Gaussians and a 64-pixel frame (`data/`), with a spec of
their own in the layout of BENCHMARK.json."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from splatbench import run

DATA = Path(__file__).resolve().parent / "data"
TRAIN, RENDER = "tiny-garden.train", "tiny-bicycle.render"
CELLS = {TRAIN: ("garden-1m-1080p.train", "tiny-garden", "train"),
         RENDER: ("bicycle-6m-4k.render", "tiny-bicycle", "render")}


def spec() -> dict:
    """BENCHMARK.json with each cell's name replaced by its tiny copy's."""
    real = run.load_json(run.ROOT / "BENCHMARK.json")
    out = copy.deepcopy(real)
    rename = {big: tiny for tiny, (big, _, _) in CELLS.items()}
    out["workloads"] = [
        dict(c, name=rename[c["name"]], config=CELLS[rename[c["name"]]][1])
        for c in real["workloads"] if c["name"] in rename]
    for section in ("end_to_end", "per_layer"):
        for m in out[section]:
            if "workloads" in m:
                m["workloads"] = [rename.get(w, w) for w in m["workloads"]]
    return out


def run_tiny(cell: str, trace: bool = False, seed: int = 2 ** 33 + 5,
             device="cpu", seconds: float = 0.3) -> dict:
    s = spec()
    c = run.find_cell(s, cell)
    return run.run_cell(s, c, seed, seconds, trace, torch.device(device),
                        time.perf_counter(), DATA)


def line(result: dict) -> dict:
    """The result as the contract's line reads it back."""
    return json.loads(json.dumps(result))
