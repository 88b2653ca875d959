"""What the benchmark's processes load: never JAX, flax or the JAX
package, compared by whole top-level name; the reference loads nothing of
the port either."""

import ast
import json
import subprocess
import sys
import types

from harness import runner
from harness.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cpu_path_tracing_tpu"}
PORT = "cpu_path_tracing_tpu_torch"


def _loaded(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"}).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import run, control\n"
            "from harness.spec import Cell\n"
            "for w in " + repr([w["name"] for w in json.loads(
                (ROOT / "BENCHMARK.json").read_text())["workloads"]]) + ":\n"
            "    c = Cell(w); c.loop()\n"
            "    [c.reader(m) for m in c.end_to_end() + c.per_layer()]\n"
            "import cpu_path_tracing_tpu_torch, cpu_path_tracing_tpu_torch.grad")
    loaded = _loaded(code)
    assert PORT in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = "import plainref.fit, plainref.render, plainref.paths, plainref.scene, plainref.rng"
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {PORT})


def test_the_reference_sources_import_only_torch_numpy_and_itself():
    allowed = {"torch", "numpy", "math", "types", "__future__"}
    for path in (BENCH_DIR / "plainref").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or "."] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)


def test_the_run_refuses_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "cpu_path_tracing_tpu_torch_like", types.ModuleType("x"))
    assert runner.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0]
                                                             for m in sys.modules})
    monkeypatch.setitem(sys.modules, "cpu_path_tracing_tpu.ops", types.ModuleType("y"))
    assert "cpu_path_tracing_tpu" in runner.forbidden_modules()
