"""The four readers of the program's spans (``advance_host_ms.backend``,
``enqueue_host_ms.backend``, ``carry_host_ms.backend``,
``launch_host_us.backend``): their values from a recorder that a tiny
CPU pool filled under a profiler, None untraced, on a count that is not
the window's, and where the program has no recorder; and a tiny traced
run of each cell on the CPU, whose line carries them."""
import time

import pytest
import torch

from benchmark import spec
from benchmark.tests.conftest import TINY, WORKLOADS

STEPS = 3
MS = ("advance_host_ms.backend", "enqueue_host_ms.backend",
      "carry_host_ms.backend")


class _Run:
    def __init__(self, steps, launches, trace=True):
        self.steps = steps
        self.trace = {"launches": launches} if trace else None


@pytest.fixture(scope="module", params=[0, 1], ids=["mpeg1", "lsf"])
def recorded(request):
    """(spans, granule steps a step) after STEPS steps of a 4-slot CPU
    pool (parse, upload, advance) under a profiler session."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.testing import mp3gen
    from pdmp3_tpu_torch.utils.trace import RECORDER

    family = request.param
    streams = [mp3gen.make_stream(n_frames=4, seed=30 + i, family=family,
                                  bitrate_index=11 if family else 9)
               for i in range(2)]
    dec = StreamDecoder(4, family=family, device="cpu")
    feeder = LoopFeeder(dec, streams)
    RECORDER.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(STEPS):
            feeder.step()
            dec.parse_step()
            dec.advance(dec.upload())
    spans = RECORDER.spans()
    yield spans, 1 if family else 2
    RECORDER.reset()


def test_readers_divide_their_span_by_the_steps(recorded):
    spans, granules = recorded
    run = _Run(STEPS, granules * STEPS)
    for name, span in zip(MS, ("pool.advance", "pool.decode",
                               "pool.carry")):
        assert spec.reader(name)(run) == pytest.approx(
            1e3 * spans[span][0] / STEPS)
    assert spec.reader("launch_host_us.backend")(run) == pytest.approx(
        1e6 * spans["step.launch"][0] / (granules * STEPS))
    advance = spec.reader(MS[0])(run)
    assert 0 < sum(spec.reader(n)(run) for n in MS[1:]) <= advance


def test_readers_read_nothing_on_another_count(recorded):
    _, granules = recorded
    for run in (_Run(STEPS + 1, granules * STEPS + 1),
                _Run(STEPS - 1, granules * STEPS - 1),
                _Run(0, 0)):
        for name in MS + ("launch_host_us.backend",):
            assert spec.reader(name)(run) is None, (name, run.steps)


def test_readers_read_nothing_untraced(recorded):
    _, granules = recorded
    run = _Run(STEPS, granules * STEPS, trace=False)
    for name in MS + ("launch_host_us.backend",):
        assert spec.reader(name)(run) is None


def test_readers_read_nothing_from_a_program_without_spans(recorded,
                                                           monkeypatch):
    """The parent program has no recorder: each reader gives None."""
    from pdmp3_tpu_torch.utils import trace
    _, granules = recorded
    monkeypatch.delattr(trace, "RECORDER")
    run = _Run(STEPS, granules * STEPS)
    for name in MS + ("launch_host_us.backend",):
        assert spec.reader(name)(run) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_traced_run_reports_the_span_metrics(workload, monkeypatch):
    """A traced run of the cell on the CPU (the profiler over the CPU
    alone): its line carries the three host-ms metrics, and the decode
    and the carry make up the advance.  No kernel launches there, so
    ``launch_host_us.backend`` reads nothing."""
    from benchmark import trace as tracing
    from benchmark.run import run_cell
    from pdmp3_tpu_torch.utils.trace import RECORDER

    class CpuProfile(tracing.Profile):
        def __init__(self):
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU])

    monkeypatch.setattr(tracing, "Profile", CpuProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    RECORDER.reset()
    out = run_cell(spec.cell(workload), 123456789012, 0.3, True,
                   torch.device("cpu"), time.perf_counter(), TINY)
    RECORDER.reset()
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(MS) <= set(got) and "launch_host_us.backend" not in got
    assert out["metrics"]["advance_host_ms.backend"]["unit"] == "ms"
    assert 0.9 * got[MS[0]] <= got[MS[1]] + got[MS[2]] <= got[MS[0]]
