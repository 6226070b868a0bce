"""What the harness and the reference load: never JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's); the plain references, the stream readers, the launch-byte
counts and the streams' maker nothing of the program and not torch."""
import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.spec import NAMED
from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pdmp3_tpu"}
# the folders of the modules a configuration names (reference/ among
# them) and the streams' maker: plain Python and NumPy alone
YARDSTICK = [os.path.join(ROOT, "benchmark", f, "") for f in NAMED.values()]


def _yardstick(path: str) -> bool:
    return path.startswith(tuple(YARDSTICK)) or os.path.basename(
        path) == "make_streams.py"


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
    """Every module of the references', the readers' and the launch-byte
    counts' folders, the roofline and the streams' maker, imported."""
    mods = ["benchmark.roofline", "benchmark.make_streams"] + [
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        for d in YARDSTICK for p in glob.glob(d + "*.py")]
    assert {"benchmark.readers.layer3", "benchmark.reference.layer3",
            "benchmark.kernel_bytes.granule"} <= set(mods)
    names = _top_level_after(
        "import importlib\n" + "".join(
            f"importlib.import_module({m!r})\n" for m in mods))
    assert not names & (FORBIDDEN | {"pdmp3_tpu_torch", "torch"})


def test_no_source_of_the_benchmark_imports_jax():
    """Every import statement under benchmark/, read from the source; the
    references, the stream readers, the launch-byte counts and the
    streams' maker import nothing of the program and not torch."""
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
            if _yardstick(path):
                assert not tops & {"pdmp3_tpu_torch", "torch"}, (path, names)
