"""What the harness and the reference load: never JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference nothing of the program."""
import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pdmp3_tpu"}


def _top_level_after(code: str) -> set:
    """Top-level names of sys.modules after running code in a fresh
    interpreter from the checkout's root."""
    probe = code + ("\nimport json, sys\nprint(json.dumps(sorted("
                    "{m.split('.')[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_tiny_run_loads_no_jax():
    names = _top_level_after("""
import time, torch
from benchmark import spec, control, trace
from benchmark.run import run_cell
from benchmark.tests.conftest import TINY
out = run_cell(spec.cell("mp3_44k1_128k_js_fast.backend"), 3, 0.2, False,
               torch.device("cpu"), time.perf_counter(), TINY)
assert out["correct"]
""")
    assert "pdmp3_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_after(
        "from benchmark.reference import decode, frontend, oracle, tables\n"
        "from benchmark import roofline, sideinfo, make_streams")
    assert not names & (FORBIDDEN | {"pdmp3_tpu_torch", "torch"})


def test_no_source_of_the_benchmark_imports_jax():
    """Every import statement under benchmark/, read from the source; the
    reference, the side-information reader and the streams' maker import
    nothing of the program."""
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN, (path, names)
            if os.sep + "reference" + os.sep in path or os.path.basename(
                    path) in ("sideinfo.py", "make_streams.py"):
                assert "pdmp3_tpu_torch" not in tops, (path, names)
