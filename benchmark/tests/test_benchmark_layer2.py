"""The MPEG-1 Layer II broadcast cell at a tiny size on the CPU: it names
the Layer II reader, reference and K7's launch-byte count; it proves
correct against the plain Layer II reference; its control (the TF32
reference) and each fault of the Layer II model step (the FIFO left
unchanged, half of the slots left out, an answer altered) come out not
correct; its streams are the bytes described; K7's count is
``chip_smoke.l12_bound``'s byte term; and the streams' maker loads
nothing of the program and not torch."""
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import corpus, spec
from benchmark.tests.conftest import ROOT

CELLS = ("mp2_48k_256k_broadcast.backend",)
MODULES = {"reader": "benchmark.readers.layer2",
           "reference": "benchmark.reference.layer2",
           "kernel.bytes": "benchmark.kernel_bytes.k7"}
STREAMS_SHA256 = ("2368539d2048ef0ea2b74c2c29302d1c4e8593bfc6968e9807fc4ba9"
                  "ff169cea")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_names_the_layer2_modules(workload):
    cfg = spec.cell(workload).config
    for key, module in MODULES.items():
        assert spec.named(cfg, key).__name__ == module


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_is_correct(tiny_run, workload):
    out = tiny_run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"setup_s", "backend_rtf"} == set(out["metrics"])
    assert out["checks"]["max_abs_lsb"]["value"] <= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_run, workload):
    out = tiny_run(workload, control=True)
    assert not out["correct"], out["checks"]
    assert all(c["value"] <= c["limit"]
               for c in out["sound_checks"].values()), out["sound_checks"]


def _patched(fault, fn):
    """decode_l12_wire with fault."""
    def step(buf, state, B, *a, **kw):
        before = state.v_blocks.clone()
        pcm, state = fn(buf, state, B, *a, **kw)
        if fault == "state_unchanged":
            state.v_blocks.copy_(before)
        elif fault == "half_left_out":
            pcm[B // 2:] = 0
            state.v_blocks[B // 2:] = before[B // 2:]
        elif fault == "answer_altered":
            pcm[:, 0, 0] = torch.clamp(pcm[:, 0, 0].to(torch.int32) + 1000,
                                       -32768, 32767).to(pcm.dtype)
        return pcm, state
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tiny_run, monkeypatch, workload, fault):
    from pdmp3_tpu_torch.models import l12 as L
    monkeypatch.setattr(L, "decode_l12_wire",
                        _patched(fault, L.decode_l12_wire))
    out = tiny_run(workload)
    assert not out["correct"], out["checks"]


def test_streams_are_the_bytes_described():
    """The .mp2 has the recorded SHA-256 (corpus.load checks it against
    the description), and the description names twolame's settings."""
    cfg = spec.cell(CELLS[0]).config
    segs, info = corpus.load(cfg["streams"])
    assert info["file"] == "twolame_48k_stereo.mp2"
    assert info["sha256"] == STREAMS_SHA256
    assert hashlib.sha256(b"".join(segs)).hexdigest() == STREAMS_SHA256
    assert len(segs) == 64 and {len(s) for s in segs} == {32 * 768}
    enc = info["encoder"]
    assert (enc["twolame"], enc["bitrate"], enc["in_samplerate"],
            enc["num_channels"], enc["mode"], enc["error_protection"]) == (
                "0.4.0", 256, 48000, 2, "J-Stereo", 1)


@pytest.mark.parametrize("n_slots, n_active",
                         [(8192, 8192), (12800, 12800), (12800, 9000)])
def test_k7_count_is_l12_bounds_byte_term(monkeypatch, n_slots, n_active):
    import chip_smoke

    from benchmark.kernel_bytes import k7
    seen = []
    monkeypatch.setattr(chip_smoke, "bound",
                        lambda nbytes, *a, **kw: seen.append(nbytes))
    chip_smoke.l12_bound(n_slots, n_active, 36, False, False)
    fmt = spec.cell(CELLS[0]).config["format"]
    assert seen == [k7.launch_bytes(n_slots, n_active, fmt)] == [
        n_slots * (4 + 36 * 128) + n_active * (36 * 256 + 2 * 7680)]
    if n_slots == n_active == 12800:
        assert seen == [373_606_400]


def test_the_streams_maker_loads_nothing_of_the_program():
    probe = ("import json, sys\nimport benchmark.make_streams_l2\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "benchmark" in names
    assert not names & {"torch", "pdmp3_tpu_torch", "pdmp3_tpu", "jax",
                        "jaxlib", "flax"}
