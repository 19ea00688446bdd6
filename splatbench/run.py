#!/usr/bin/env python3
"""Run one cell of the benchmark of `gsplat_tpu_torch` and print its line.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program. The cell, its
configuration (`splatbench/configs/<config>.json`), its traffic
(`splatbench/traffic/<traffic>.json`, whose "kind" names the driver in
`splatbench/kinds/`), its limits (`splatbench/limits/<cell>.json`) and its
per-layer metrics (`splatbench/metrics/<metric>.py`) are found by the
names in `BENCHMARK.json`. With --trace 0 the line carries the cell's
end-to-end metrics, measured over a window of --seconds; with --trace 1
its per-layer metrics, read from a profiled window of a fixed number of
calls. Either way the program's outputs are then held to the reference,
and the numbers compared are printed with their limits as the last lines
on standard error and under "checks", the line's last key.

Exits with 3, printing no line, without as many CUDA cards as the cell
asks for, and with 4 if JAX or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level modules the run's process may not hold: JAX and the JAX
# package (compared as whole names: the program's own name begins with the
# JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")
HOST_THREADS = 2


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, section: str, cell: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    cell reports: those listing it, and those that list no cells."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def metric_reader(name: str):
    """The `read(trace)` of splatbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"splatbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def load_cell(cell: dict, base: Path = HERE) -> tuple[dict, dict]:
    """(configuration, traffic) of a cell, found by name."""
    return (load_json(base / "configs" / f"{cell['config']}.json"),
            load_json(base / "traffic" / f"{cell['traffic']}.json"))


def load_limits(cell: str, base: Path = HERE) -> dict:
    path = base / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in load_json(path).items()}


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, start: float, base: Path = HERE) -> dict:
    """The cell's result line (a dict) on `device`."""
    import torch

    from splatbench import compare, tracing

    config, traffic = load_cell(cell, base)
    kind = importlib.import_module(f"splatbench.kinds.{traffic['kind']}")
    ctx = types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                device=device)
    kind.setup(ctx)
    setup_s = time.perf_counter() - start
    if trace:
        prof, window_s, calls = kind.traced_window(ctx)
        measured = {}
    else:
        measured = kind.window(ctx, seconds)["metrics"]
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind.wind_down(ctx, trace)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": {}, "device": dev}
    if trace:
        tr = tracing.reduce(prof, window_s, calls, ctx.eager)
        del prof
        tr.update(work=kind.work(ctx), cell=cell["name"], config=config)
        for m in cell_metrics(spec, "per_layer", cell["name"]):
            value = metric_reader(m["name"])(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    else:
        e2e = dict(measured, setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        for m in cell_metrics(spec, "end_to_end", cell["name"]):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    numbers = kind.numbers(ctx)
    print(f"readings: {json.dumps(ctx.detail)}", file=sys.stderr)
    limits = load_limits(cell["name"], base)
    if set(limits) == set(numbers):
        result["correct"], checks = compare.judge(numbers, limits)
    else:
        checks = {k: {"value": v, "limit": limits.get(k)}
                  for k, v in numbers.items()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(spec, args.workload)

    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"splatbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from splatbench import frozen

    device = torch.device("cuda", 0)
    print(f"splatbench: {args.workload} seed {args.seed} on "
          f"{frozen.device_name(0)}", file=sys.stderr, flush=True)
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      device, START)
    loaded = forbidden_modules()
    if loaded:
        print(f"splatbench: the run's process holds {loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
