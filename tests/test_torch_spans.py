"""The program's spans (pdmp3_tpu_torch/utils/trace.py ``span``,
``RECORDER``) on a tiny CPU pool, MPEG-1 and LSF, and on a Layer II
pool, whose model step is K9's requantization and K7's launches.

Under a profiler session (``utils.trace.Trace``) the pipelined serving
loop's spans land in the session's Chrome trace, nested as the step runs
them (``pool.advance`` holds ``pool.decode``, which holds the model
step's ``step.expand`` (the MPEG-1 coded wire's widening, once a step,
outside every ``step.launch``) and ``step.widen`` / ``step.launch`` /
``step.join``, then ``pool.carry``), each around the work its metric
names, and the recorder counts one of each a step or a granule step; without a session the
recorder stays empty, and the PCM is the same bits either way.  The
advance copies no wire view and selects no views: the reclaim, the idle
slot-frames' meta and the views' selection belong to the parse step.  On
the card, the served loop's two waits are spans too."""
import collections
import json

import numpy as np
import pytest
import torch

from pdmp3_tpu_torch import L12StreamDecoder, LoopFeeder, StreamDecoder
from pdmp3_tpu_torch.models import decoder as M
from pdmp3_tpu_torch.models import l12 as L
from pdmp3_tpu_torch.testing import mp3gen
from pdmp3_tpu_torch.utils import Trace, trace

STEPS = 3
SLOTS = 4


def _streams(family):
    """Four streams, the first with lines outside -7..7 (escapes on the
    MPEG-1 pool's coded wire)."""
    return [mp3gen.make_stream(n_frames=6, seed=70 + 10 * family + i,
                               family=family,
                               bitrate_index=11 if family else 9,
                               blocks=["long", "short", "mixed",
                                       "varied"][i],
                               mode=[0, 1, 1, 3][i], mode_extension=2,
                               amp=40 if i == 0 else 6)
            for i in range(SLOTS)]


# What each span encloses: a probe (a profiler annotation, which the
# recorder does not count) around each piece of the step's work, and the
# innermost program span each probe must sit in.  Moving work across
# these spans redefines the metrics that read them.
ENCLOSED = {"probe.decode": "pool.decode", "probe.expand": "step.expand",
            "probe.widen": "step.widen", "probe.launch": "step.launch"}
# The pool's work between steps, inside each parse_step (probed), in this
# order, and never inside pool.advance.
PARSE_STEP = ("probe.reclaim", "probe.keep_meta", "probe.show")


class _Probed(np.ndarray):
    """A wire view whose copies are probed."""

    def copy(self, *args, **kwargs):
        with torch.profiler.record_function("probe.copy"):
            return np.asarray(self).copy(*args, **kwargs)


def _probe(fn, name):
    def probed(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return probed


def _probe_pool(dec, monkeypatch):
    """Probes around the pool's and the model step's pieces of work."""
    monkeypatch.setattr(M, "_batch_from_meta",
                        _probe(M._batch_from_meta, "probe.widen"))
    monkeypatch.setattr(M, "fused_granule_step",
                        _probe(M.fused_granule_step, "probe.launch"))
    monkeypatch.setattr(M, "l3_expand", _probe(M.l3_expand, "probe.expand"))
    dec._decode = _probe(dec._decode, "probe.decode")
    dec._reclaim = _probe(dec._reclaim, "probe.reclaim")
    dec._keep_idle_meta = _probe(dec._keep_idle_meta, "probe.keep_meta")
    dec._show = _probe(dec._show, "probe.show")
    dec.parse_step = _probe(dec.parse_step, "probe.parse_step")
    for views in dec._sets:
        for name, a in views.items():
            views[name] = a.view(_Probed)
    dec.__dict__.update(dec._sets[dec._shown])


def _serve(family, monkeypatch=None, device="cpu", escapes=None):
    """STEPS parse + decode_step_pipelined steps of a looping 4-slot
    pool, then the flush: the PCM of every step; with `monkeypatch`, the
    pool's work probed; each parse step's escapes (an MPEG-1 pool's
    coded wire) appended to `escapes`."""
    dec = StreamDecoder(SLOTS, family=family, device=device)
    if monkeypatch is not None:
        _probe_pool(dec, monkeypatch)
    feeder = LoopFeeder(dec, _streams(family))
    out = []
    for _ in range(STEPS):
        feeder.step()
        assert dec.parse_step() == SLOTS
        if escapes is not None and not family:
            escapes.append(dec._esc_used.value)
        pcm = dec.decode_step_pipelined()
        if pcm is not None:
            out.append(pcm)
    out.append(dec.drain_pending())
    return np.stack(out)


def _events(path, prefixes):
    """(start, end, name) of the trace's complete events whose names
    start with one of `prefixes`, outermost first at a tie."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e["name"].startswith(prefixes)),
                  key=lambda n: (n[0], -n[1]))


@pytest.fixture(scope="module", params=[0, 1], ids=["mpeg1", "lsf"])
def served(request, tmp_path_factory):
    """The same loop with the profiler on (under ``Trace``, its work
    probed) and off: the PCM, the recorder's spans after each, the
    trace's program spans and its probes."""
    family = request.param
    trace.RECORDER.reset()
    off = _serve(family)
    spans_off = trace.RECORDER.spans()
    report_off = trace.RECORDER.report()
    out = tmp_path_factory.mktemp("trace")
    parsed = []
    with pytest.MonkeyPatch.context() as monkeypatch:
        with Trace(str(out)):
            on = _serve(family, monkeypatch, escapes=parsed)
    spans_on = trace.RECORDER.spans()
    kept = trace.RECORDER.counts.get("pool.meta_kept")
    escapes = trace.RECORDER.counts.get("pool.ix_escapes")
    trace.RECORDER.reset()
    files = sorted(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    return dict(family=family, off=off, on=on, spans_off=spans_off,
                report_off=report_off, spans_on=spans_on, kept=kept,
                escapes=escapes, parsed_escapes=parsed,
                notes=_events(files[0], ("pool.", "step.")),
                probes=_events(files[0], ("probe.",)),
                cats=_events(files[0], ("aten::cat",)))


def test_spans_nest_as_the_step_runs(served):
    """Each pool.advance holds one pool.decode, then one pool.carry; each
    pool.decode holds the MPEG-1 wire's step.expand first, then its
    granule steps' step.widen and step.launch, in turn, and the MPEG-1
    granules' step.join, none inside another; nothing else runs
    inside."""
    notes = served["notes"]
    adv = [n for n in notes if n[2] == "pool.advance"]
    assert len(adv) == STEPS
    granules = 1 if served["family"] else 2
    want = (([] if served["family"] else ["step.expand"])
            + ["step.widen", "step.launch"] * granules
            + ([] if served["family"] else ["step.join"]))
    for a0, a1, _ in adv:
        inner = [n for n in notes if a0 <= n[0] and n[1] <= a1
                 and n[2] != "pool.advance"]
        top = [n for n in inner if not any(
            o[0] <= n[0] and n[1] <= o[1] and o is not n for o in inner)]
        assert [n[2] for n in top] == ["pool.decode", "pool.carry"]
        (d0, d1, _), (c0, _, _) = top
        assert d1 <= c0
        steps = [n for n in inner if d0 <= n[0] and n[1] <= d1
                 and n[2] != "pool.decode"]
        assert [n[2] for n in steps] == want
        assert all(p[1] <= n[0] for p, n in zip(steps, steps[1:]))
    outside = {n[2] for n in notes
               if not any(a0 <= n[0] and n[1] <= a1 for a0, a1, _ in adv)}
    assert outside == {"pool.parse", "pool.upload", "pool.drain"}


def test_spans_enclose_the_work_their_metrics_name(served):
    """Inside each pool.advance, every probed piece of work sits in the
    span that its metric reads (ENCLOSED), innermost: the model step's
    call in pool.decode, the MPEG-1 coded wire's widening of the lines
    in step.expand, the widening of meta and active in step.widen, the
    granule step's call in step.launch, and nothing else is probed
    there; and the MPEG-1 granules' concatenation is the step.join."""
    notes = served["notes"]
    granules = 1 if served["family"] else 2
    want = {"probe.decode": 1, "probe.widen": granules,
            "probe.launch": granules}
    if not served["family"]:
        want["probe.expand"] = 1
    for a0, a1, _ in (n for n in notes if n[2] == "pool.advance"):
        seen = collections.Counter()
        for p0, p1, probe in served["probes"]:
            if not (a0 <= p0 and p1 <= a1):
                continue
            assert probe in ENCLOSED, probe
            around = [n for n in notes if n[0] <= p0 and p1 <= n[1]]
            innermost = min(around, key=lambda n: n[1] - n[0])
            assert innermost[2] == ENCLOSED[probe], (probe, innermost)
            seen[probe] += 1
        assert dict(seen) == want
    joins = [n for n in notes if n[2] == "step.join"]
    assert len(joins) == (0 if served["family"] else STEPS)
    for j0, j1, _ in joins:
        assert [c[2] for c in served["cats"]
                if j0 <= c[0] and c[1] <= j1] == ["aten::cat"]


def test_advance_copies_no_wire_view_and_selects_no_views(served):
    """No pool.advance holds the reclaim, the idle slot-frames' meta or a
    selection of views, and no copy of a wire view runs anywhere in the
    served loop: the advance writes no host byte."""
    advances = [n for n in served["notes"] if n[2] == "pool.advance"]
    assert len(advances) == STEPS
    probes = served["probes"]
    assert not [p for p in probes if p[2] == "probe.copy"]
    for p0, p1, probe in probes:
        if probe in PARSE_STEP:
            assert not any(a0 <= p0 and p1 <= a1 for a0, a1, _ in advances)


def test_the_reclaim_and_the_idle_meta_sit_under_parse_step(served):
    """Each parse step holds one reclaim, one keep of the idle
    slot-frames' meta and one selection of views, in that order, around
    its native parse (the program's pool.parse); none runs outside a
    parse step."""
    parses = [p for p in served["probes"] if p[2] == "probe.parse_step"]
    assert len(parses) == STEPS
    inner = [p for p in served["probes"] if p[2] in PARSE_STEP]
    assert len(inner) == len(PARSE_STEP) * STEPS
    for s0, s1, _ in parses:
        held = [p for p in inner if s0 <= p[0] and p[1] <= s1]
        assert tuple(p[2] for p in held) == PARSE_STEP
        (parse,) = [n for n in served["notes"] if n[2] == "pool.parse"
                    and s0 <= n[0] and n[1] <= s1]
        assert held[0][1] <= parse[0] and parse[1] <= held[1][0]


def test_recorder_counts_every_step_and_granule_step(served):
    """The recorder's counts equal the steps run and the granule steps
    they launched, and the annotations in the trace; every slot is
    active, so no parse step keeps a meta row (``pool.meta_kept``); an
    MPEG-1 pool counts the escapes its parse steps wrote
    (``pool.ix_escapes``), an LSF pool none."""
    granules = 1 if served["family"] else 2
    want = {"pool.parse": STEPS, "pool.upload": STEPS,
            "pool.advance": STEPS, "pool.decode": STEPS,
            "pool.carry": STEPS, "pool.drain": STEPS,
            "step.widen": granules * STEPS,
            "step.launch": granules * STEPS}
    if not served["family"]:
        want["step.join"] = want["step.expand"] = STEPS
    spans = served["spans_on"]
    assert {k: c for k, (_, c) in spans.items()} == want
    assert served["kept"] == 0
    if served["family"]:
        assert served["escapes"] is None
    else:
        assert len(served["parsed_escapes"]) == STEPS
        assert served["escapes"] == sum(served["parsed_escapes"]) > 0
    names = [n[2] for n in served["notes"]]
    assert {k: names.count(k) for k in want} == want
    # the decode and the carry make up the advance, less the spans' cost
    sec = {k: s for k, (s, _) in spans.items()}
    assert sec["pool.decode"] + sec["pool.carry"] <= sec["pool.advance"]
    assert sec["step.launch"] <= sec["pool.decode"]


def test_recorder_stays_empty_without_a_profiler(served):
    assert served["spans_off"] == {}
    assert served["report_off"] == {}


def test_pcm_is_the_same_with_the_profiler_on_and_off(served):
    assert served["off"].shape == (STEPS, SLOTS,
                                   576 if served["family"] else 1152, 2)
    np.testing.assert_array_equal(served["on"], served["off"])


def test_span_is_a_shared_no_op_without_a_profiler():
    """Off, every span is the one no-op; on, a span records its name's
    seconds and count, also when its body raises."""
    trace.RECORDER.reset()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        pass
    with pytest.raises(KeyError):
        with trace.span("a"):
            raise KeyError("span bodies may raise")
    assert trace.RECORDER.spans() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("outer"):
            with pytest.raises(KeyError):
                with trace.span("inner"):
                    raise KeyError("span bodies may raise")
    spans = trace.RECORDER.spans()
    assert {k: c for k, (_, c) in spans.items()} == {"outer": 1,
                                                      "inner": 1}
    assert 0 < spans["inner"][0] <= spans["outer"][0]
    assert trace.RECORDER.report()["outer"]["count"] == 1
    trace.RECORDER.reset()
    assert trace.RECORDER.spans() == {} and trace.RECORDER.report() == {}



def test_spans_are_annotations_inside_trace_alone(tmp_path):
    """In a profiler session of its own (the benchmark's) a span is the
    recorder's alone, with no event in the session's trace; inside
    ``Trace`` it is an event of the trace too, and ``Trace`` leaves the
    spans unannotated after it, also when its body raises."""
    trace.RECORDER.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("pool.own"):
            torch.zeros(2).add_(1)
    assert [e.name for e in prof.events() if e.name == "pool.own"] == []
    with pytest.raises(KeyError):
        with Trace(str(tmp_path)):
            with trace.span("pool.own"):
                torch.zeros(2).add_(1)
            raise KeyError("a traced body may raise")
    files = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert [n[2] for n in _events(files[0], ("pool.",))] == ["pool.own"]
    assert trace.RECORDER.spans()["pool.own"][1] == 2
    assert trace._annotate is False
    trace.RECORDER.reset()


def _serve_l12(F, monkeypatch=None):
    """STEPS parse + decode_step_pipelined steps of a looping 4-slot
    Layer II pool of F frames a step, then the flush: the PCM of every
    step; with `monkeypatch`, the model step's requantization and its
    calls into K7 probed."""
    if monkeypatch is not None:
        monkeypatch.setattr(L, "l12_requant",
                            _probe(L.l12_requant, "probe.requant"))
        monkeypatch.setattr(L, "decode_l12_frames",
                            _probe(L.decode_l12_frames, "probe.launch"))
    dec = L12StreamDecoder(SLOTS, layer=2, frames_per_step=F, device="cpu")
    feeder = LoopFeeder(dec, [mp3gen.make_l12_stream(
        layer=2, n_frames=6, seed=90 + i, bitrate_index=12,
        mode=[0, 1, 1, 3][i], mode_extension=i) for i in range(SLOTS)])
    out = []
    for _ in range(STEPS):
        feeder.step()
        assert dec.parse_step() == SLOTS * F
        pcm = dec.decode_step_pipelined()
        if pcm is not None:
            out.append(pcm)
    out.append(dec.drain_pending())
    return np.stack(out)


@pytest.mark.parametrize("F", [1, 2])
def test_layer2_pool_decode_holds_a_launch_a_frame(F, tmp_path,
                                                   monkeypatch):
    """In a Layer II pool's pool.decode, the requantization of the step's
    coded frames (K9's one launch) is a step.requant, then the model
    step's call into K7 for each of its F frames is a step.launch, in
    turn, then (F > 1) one step.join around the frames' concatenation;
    the recorder counts STEPS requantizations and STEPS x F launches; the
    PCM is the same bits with the profiler off."""
    trace.RECORDER.reset()
    off = _serve_l12(F)
    assert trace.RECORDER.spans() == {}
    with Trace(str(tmp_path)):
        on = _serve_l12(F, monkeypatch)
    spans = trace.RECORDER.spans()
    trace.RECORDER.reset()
    assert off.shape == (STEPS, SLOTS, F * 1152, 2)
    np.testing.assert_array_equal(on, off)
    want = {"pool.advance": STEPS, "pool.decode": STEPS,
            "step.requant": STEPS, "step.launch": F * STEPS}
    if F > 1:
        want["step.join"] = STEPS
    assert {k: spans[k][1] for k in want} == want
    assert spans["step.launch"][0] <= spans["pool.decode"][0]
    (path,) = sorted(tmp_path.glob("*.pt.trace.json"))
    notes = _events(path, ("pool.", "step."))
    cats = _events(path, ("aten::cat",))
    probes = _events(path, ("probe.",))
    assert [p[2] for p in probes].count("probe.requant") == STEPS
    assert [p[2] for p in probes].count("probe.launch") == F * STEPS
    for p0, p1, name in probes:
        inner = min((n for n in notes if n[0] <= p0 and p1 <= n[1]),
                    key=lambda n: n[1] - n[0])
        assert inner[2] == {"probe.requant": "step.requant",
                            "probe.launch": "step.launch"}[name]
    decodes = [n for n in notes if n[2] == "pool.decode"]
    assert len(decodes) == STEPS
    for d0, d1, _ in decodes:
        inner = [n for n in notes if d0 <= n[0] and n[1] <= d1
                 and n[2] != "pool.decode"]
        assert [n[2] for n in inner] == (["step.requant"]
                                         + ["step.launch"] * F
                                         + ["step.join"] * (F > 1))
        assert all(p[1] <= n[0] for p, n in zip(inner, inner[1:]))
        for j0, j1, _ in inner[1 + F:]:
            assert [c[2] for c in cats
                    if j0 <= c[0] and c[1] <= j1] == ["aten::cat"]


@pytest.mark.cuda
@pytest.mark.parametrize("family", [0, 1], ids=["mpeg1", "lsf"])
def test_the_served_loops_waits_are_spans_on_the_card(family, tmp_path):
    """On the card the pipelined loop's two waits are spans, each once
    a wait: the upload fence in the parse step's reclaim, before its
    native parse and outside pool.advance, on every step but the first
    two (whose buffers were never uploaded), and the drain's in the
    fetch of each step's PCM, outside pool.advance (the last at the
    flush)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trace.RECORDER.reset()
    with Trace(str(tmp_path)):
        pcm = _serve(family, device="cuda")
    spans = trace.RECORDER.spans()
    trace.RECORDER.reset()
    assert pcm.shape == (STEPS, SLOTS, 576 if family else 1152, 2)
    assert spans["pool.wait_upload"][1] == STEPS - 2
    assert spans["pool.wait_pcm"][1] == STEPS
    assert spans["pool.advance"][1] == STEPS
    files = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    notes = _events(files[0], ("pool.", "step."))
    advances = [n for n in notes if n[2] == "pool.advance"]
    for w0, w1, name in notes:
        if name in ("pool.wait_upload", "pool.wait_pcm"):
            assert not any(a0 <= w0 and w1 <= a1 for a0, a1, _ in advances)
        if name == "pool.wait_upload":
            after = [n[2] for n in notes if n[0] >= w1 and n[2] in (
                "pool.parse", "pool.upload", "pool.advance")]
            assert after[0] == "pool.parse"
    names = [n[2] for n in notes]
    assert names.count("pool.wait_upload") == STEPS - 2
    assert names.count("pool.wait_pcm") == STEPS
