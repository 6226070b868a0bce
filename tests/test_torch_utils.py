"""The port's utilities (pdmp3_tpu_torch/utils/) against the JAX
package's: the stage timer's report over the same calls on the same
clock, the per-stage debug dumps' text, the configuration's environment
overrides, and the torch.profiler trace scope.

Tolerance: none; every comparison is equality.
"""
import io
import json
import time

import numpy as np
import pytest
import torch

from pdmp3_tpu.frontend import Frontend as JaxFrontend
from pdmp3_tpu.utils import DecodeConfig as JaxDecodeConfig
from pdmp3_tpu.utils import StageTimer as JaxStageTimer
from pdmp3_tpu.utils import dumps as jax_dumps
from pdmp3_tpu_torch.frontend import Frontend
from pdmp3_tpu_torch.testing import mp3gen
from pdmp3_tpu_torch.utils import DecodeConfig, StageTimer, Trace, dumps


def _drive(timer):
    for name, n in (("parse", 3), ("decode", 2), ("parse", 1)):
        with timer.stage(name):
            pass
        timer.count("frames", n)
    try:
        with timer.stage("upload"):
            raise KeyError("stage bodies may raise")
    except KeyError:
        pass
    return timer.report()


def test_stage_timer_reports_equal_jax(monkeypatch):
    """The same stage and count calls on the same clock (a fake
    perf_counter, 0.125 s a tick) report the same seconds and counts."""
    reports = []
    for make in (StageTimer, JaxStageTimer):
        ticks = iter(np.arange(100) * 0.125)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        reports.append(_drive(make()))
    assert reports[0] == reports[1]
    assert reports[0]["parse"] == {"seconds": 0.25, "count": 2}
    assert reports[0]["frames"]["count"] == 6


@pytest.mark.parametrize("spec", [
    dict(blocks="long"), dict(blocks="short", mode=1, mode_extension=2),
    dict(blocks="mixed", sfreq=2), dict(blocks="varied", mode=3)],
    ids=["long", "short_ms", "mixed_32k", "varied_mono"])
def test_dump_frame_text_equals_jax(spec):
    """dump_frame of the same parsed frame, and dump_samples of the same
    samples, print the same text in the port and the JAX package."""
    data = mp3gen.make_stream(n_frames=3, seed=5, **spec)
    texts = []
    for fe, mod in ((Frontend(), dumps), (JaxFrontend(), jax_dumps)):
        fe.feed(data)
        res, fd = fe.read_frame()
        assert res == 0
        buf = io.StringIO()
        mod.dump_frame(fd, out=buf)
        mod.dump_samples(np.linspace(-1.5, 1.5, 9, dtype=np.float32), 2,
                         out=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "HUFFMAN" in texts[0] and "SAMPLES2" in texts[0]


def test_decode_config_env_overrides_equal_jax(monkeypatch):
    for k, v in (("PDMP3_PRECISION", "fast"), ("PDMP3_BUG_COMPAT", "0"),
                 ("PDMP3_BATCH_SLOTS", "4096")):
        monkeypatch.setenv(k, v)
    got, want = DecodeConfig.from_env(), JaxDecodeConfig.from_env()
    assert vars(got) == vars(want)
    assert not got.exact and got.batch_slots == 4096


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    """Trace(dir) writes one Chrome trace of the ops inside it into dir;
    Trace(None) writes nothing (here: nothing in the working
    directory)."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "trace"
    with Trace(str(out)):
        torch.ones(64).cumsum(0)
    files = sorted(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    before = sorted(tmp_path.rglob("*"))
    with Trace(None):
        torch.ones(64).cumsum(0)
    assert sorted(tmp_path.rglob("*")) == before
