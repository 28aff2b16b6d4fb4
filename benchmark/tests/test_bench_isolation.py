"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gags_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    for path in _sources():
        for name in _imports(path):
            seen += 1
            assert name.split(".", 1)[0] not in FORBIDDEN, f"{path}: imports {name}"
    assert seen > 50


def test_reference_and_counts_import_nothing_of_the_port():
    for sub in ("reference", "counts"):
        for path in (BENCH / sub).rglob("*.py"):
            for name in _imports(path):
                assert name.split(".", 1)[0] != "gags_torch", f"{path}: imports {name}"


def test_whole_name_compare():
    # the port's name begins with the JAX package's stem; only whole
    # top-level names count
    from benchmark.lib import harness

    before = set(sys.modules)
    sys.modules["gags_torchlike"] = sys.modules["sys"]
    try:
        assert "gags_torchlike" not in harness.forbidden_modules()
    finally:
        if "gags_torchlike" not in before:
            del sys.modules["gags_torchlike"]


def test_modules_after_a_cpu_rehearsal():
    """A whole tiny run, then every entry of sys.modules in its process."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['run.py', '--workload', 'gad-tiny-train', '--seed', '5', '--seconds', '1',"
        " '--trace', '0', '--spec', 'benchmark/tests/data/spec.json', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print('MODULES', sorted({m.split('.')[0] for m in sys.modules if sys.modules[m]}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("MODULES")][-1]
    tops = set(eval(line[len("MODULES "):]))
    assert "gags_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
