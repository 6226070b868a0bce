"""The benchmark's cells at a tiny size on the CPU: each proves correct
against the plain reference; its control and each fault that the cells
can have (a step that leaves the state unchanged, half of the slots left
out, an answer altered where it is produced) come out not correct; a
new cell is a new set of files."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT, WORKLOADS


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_cell_is_correct(tiny_run, workload):
    out = tiny_run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"setup_s", "backend_rtf"} == set(out["metrics"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny_run, workload):
    out = tiny_run(workload, control=True)
    assert not out["correct"], out["checks"]


def _patched(fault):
    """A wrapper of a model step (decode_frame_packed[_lsf]) with fault."""
    def wrap(fn):
        def step(buf, state, B, *a, **kw):
            before = [t.clone() for t in (state.store, state.v_blocks,
                                          state.prev_lines)]
            pcm, state = fn(buf, state, B, *a, **kw)
            saved = zip((state.store, state.v_blocks, state.prev_lines),
                        before)
            if fault == "state_unchanged":
                for t, b in saved:
                    t.copy_(b)
            elif fault == "half_left_out":
                pcm[B // 2:] = 0
                for t, b in saved:
                    t[B // 2:] = b[B // 2:]
            elif fault == "answer_altered":
                pcm[:, 0, 0] = torch.clamp(pcm[:, 0, 0].to(torch.int32)
                                           + 1000, -32768, 32767).to(
                                               pcm.dtype)
            return pcm, state
        return step
    return wrap


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(tiny_run, monkeypatch, workload, fault):
    from pdmp3_tpu_torch.models import decoder as M
    for name in ("decode_frame_packed", "decode_frame_packed_lsf"):
        monkeypatch.setattr(M, name, _patched(fault)(getattr(M, name)))
    out = tiny_run(workload)
    assert not out["correct"], out["checks"]


def test_a_pool_setting_the_pool_does_not_take_is_refused():
    from benchmark.run import make_pool
    with pytest.raises(ValueError, match="sparse_wire"):
        make_pool({"class": "StreamDecoder", "slots": 2, "sparse_wire": 1},
                  torch.device("cpu"))
    with pytest.raises(ValueError, match="device"):
        make_pool({"class": "StreamDecoder", "slots": 2, "device": "cpu"},
                  torch.device("cpu"))


NEW_READER = '''"""wait_ms.backend: host ms a step waits for its PCM."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * run.spans.get("wait", 0.0) / run.steps
'''


# (folder, module copied, its copy): the modules a configuration of a
# new format names, here copies of the Layer III ones under new names
COPIES = [("readers", "layer3", "copy3"), ("reference", "layer3", "copy3"),
          ("kernel_bytes", "granule", "copy_granule")]


@pytest.mark.parametrize("new_format", [False, True],
                         ids=["same_format", "new_format"])
def test_a_new_cell_is_only_new_files(tmp_path, new_format):
    """Copy the benchmark, add a configuration, a traffic mix with a
    driver of its own, a metric and a cell as files and entries, and run
    the new cell's set-up, window and reference at a tiny size; no file
    that was there changes.  In a new format the configuration also names
    a stream reader, a plain reference and a launch-byte count of its own,
    each a new file, and its streams lie in a file of another name that a
    new description names: the cell comes out correct, its control (the
    TF32 reference) not correct, and the run loads none of the modules it
    does not name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "mp3_44k1_128k_js_fast.json")
                     .read_text())
    cfg["pool"]["exact"] = True
    cfg["kernel"] = {"name": "fused_granule_kernel<true>",
                     "counter": "fused_granule_exact", "bytes": "granule"}
    cfg["limits"] = {"max_abs_lsb": 0, "off_share": 0}
    if new_format:
        for folder, old, copy in COPIES:
            shutil.copy(b / folder / (old + ".py"), b / folder / (copy + ".py"))
        cfg.update(reader="copy3", reference="copy3", streams="copy_44k1")
        cfg["kernel"]["bytes"] = "copy_granule"
        info = json.loads((b / "streams" / "lame_44k1_stereo.json")
                          .read_text())
        info["file"] = "copy_44k1.mp2"
        (b / "streams" / "copy_44k1.json").write_text(json.dumps(info))
        shutil.copy(b / "streams" / "lame_44k1_stereo.mp3",
                    b / "streams" / "copy_44k1.mp2")
    (b / "configs" / "mp3_44k1_128k_js_exact.json").write_text(
        json.dumps(cfg))
    mix = json.loads((b / "traffic" / "backend.json").read_text())
    mix.update(driver="replay", distinct=2, warmup_steps=2,
               pool={"parse_threads": 2})
    (b / "traffic" / "backend2.json").write_text(json.dumps(mix))
    (b / "drivers" / "replay.py").write_text(
        "from benchmark.drivers.backend import run  # noqa: F401\n")
    (b / "metrics" / "wait_ms.backend.py").write_text(NEW_READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mp3_44k1_128k_js_exact",
                             "source": "ISO/IEC 11172-3", "reduced": [],
                             "file": "benchmark/configs/"
                             "mp3_44k1_128k_js_exact.json", "why": "test"})
    cell = "mp3_44k1_128k_js_exact.backend2"
    bench["workloads"].append({"name": cell,
                               "config": "mp3_44k1_128k_js_exact",
                               "traffic": "backend2", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "wait_ms.backend", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "harness", "moves": "backend_rtf",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    candidates = [f"benchmark.{f}.{m}" for f, old, copy in COPIES
                  for m in (old, copy)]
    code = f"""
import json, sys, time, torch
from benchmark import spec
from benchmark.run import run_cell
from benchmark.tests.conftest import TINY
cell = spec.cell({cell!r})
out = run_cell(cell, 5, 0.3, False, torch.device("cpu"), time.perf_counter(),
               TINY)
ctl = run_cell(cell, 5, 0.3, False, torch.device("cpu"), time.perf_counter(),
               TINY, control=True) if {new_format!r} else None
named = sorted(set(sys.modules) & set({candidates!r}))
print(json.dumps([out, ctl, cell.config["pool"]["exact"],
                  [m["name"] for m in cell.per_layer], named]))
"""
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out, ctl, exact, per_layer, named = json.loads(
        res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert exact and per_layer == ["wait_ms.backend"]
    assert {"backend_rtf", "setup_s"} == set(out["metrics"])
    if new_format:
        assert not ctl["correct"], ctl["checks"]
        assert named == sorted(f"benchmark.{f}.{c}" for f, _, c in COPIES)
    else:
        assert named == ["benchmark.kernel_bytes.granule",
                         "benchmark.readers.layer3",
                         "benchmark.reference.layer3"]
    assert all(p.read_bytes() == data for p, data in before.items()
               if p.name != "BENCHMARK.json")
