"""Nothing a run imports has the top-level name jax, jaxlib, flax or
gsplat_tpu (whole names: the program's own begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from splatbench import run

HERE = run.HERE


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _loaded_after(code: str) -> list:
    script = (f"import sys; sys.path.insert(0, {str(run.ROOT)!r})\n{code}\n"
              "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=run.ROOT)
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1].split(",")


def test_a_run_loads_no_jax():
    loaded = _loaded_after(
        "import splatbench.run, splatbench.readings, splatbench.port\n"
        "import splatbench.kinds.train, splatbench.kinds.render\n"
        "import gsplat_tpu_torch.train.loop, gsplat_tpu_torch.render.pipeline\n"
        "from splatbench import run\n"
        "for m in run.load_json(run.ROOT / 'BENCHMARK.json')['per_layer']:\n"
        "    run.metric_reader(m['name'])")
    assert "gsplat_tpu_torch" in loaded
    assert run.forbidden_modules(loaded) == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import splatbench.reference.render, "
                           "splatbench.reference.train, splatbench.compare, "
                           "splatbench.gen, splatbench.roofline")
    assert "gsplat_tpu_torch" not in loaded
    assert run.forbidden_modules(loaded) == []
    for path in (HERE / "reference").glob("*.py"):
        assert not _top_level_imports(path) & {
            "gsplat_tpu_torch", "gsplat_tpu", "jax", "jaxlib", "flax"}, path


def test_no_source_of_the_benchmark_names_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_level_imports(path) & {
            "gsplat_tpu", "jax", "jaxlib", "flax"}, path
