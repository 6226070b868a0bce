"""The pool's two wire buffers between steps (``runtime/scheduler.py``
``_Pool``): ``advance`` turns the pool to the other buffer and writes
neither; ``parse_step`` parses into it and copies the last step's meta
into the slot-frames the parse left idle, the one carry the wire needs.

Held against a reference pool that carries every step's active and meta
in ``advance``, as the pools did before: driven from the same feeds,
with churn (streams of different lengths, a slot never fed, a slot
joined mid-run, a finished slot fed again), every pool kind uploads the
same wire bytes a step, idle slots included, gives the same PCM, and
shows the same active, meta and nch after each parse and each decode.
The recorder's ``pool.meta_kept`` counts the idle slot-frames."""
import contextlib

import numpy as np
import pytest
import torch

from pdmp3_tpu_torch import (L12StreamDecoder, ShardedStreamDecoder,
                             SparseStreamDecoder, StreamDecoder, make_mesh)
from pdmp3_tpu_torch.testing import mp3gen
from pdmp3_tpu_torch.utils import trace

B = 6
STEPS = 12
NEVER_FED = 4
JOINED = 5
JOIN_STEP = 2
REFED, REFEED_STEP = 0, 7
KINDS = ["mpeg1", "lsf", "sparse", "layer2", "frames2", "sharded"]


class _CarryEveryStep:
    """The carry as ``advance`` made it before: this step's active and
    meta copied, the views turned to the other buffer, that buffer
    reclaimed and both copies written over it; ``parse_step`` parses
    into that buffer as it stands (with what the wire itself does after
    its packer, ``_parsed``: the coded MPEG-1 wire's escape bucket)."""

    def advance(self, wire):
        pcm, self.state = self._decode(wire)
        act, meta = self.active.copy(), self.meta.copy()
        self._cur ^= 1
        self._show(self._cur)
        self._reclaim()
        self.active[:] = act
        self.meta[:] = meta
        return pcm

    def parse_step(self):
        self._reclaim()
        views = self._sets[self._cur]
        n = self._fn(self._handle_arr, self.n, self.parse_threads, self.F,
                     *self._packer_args(views))
        self._parsed(views)
        return n


class _RefStream(_CarryEveryStep, StreamDecoder):
    pass


class _RefSparse(_CarryEveryStep, SparseStreamDecoder):
    pass


class _RefL12(_CarryEveryStep, L12StreamDecoder):
    pass


class _RefSharded(ShardedStreamDecoder):
    def __init__(self, n_slots, mesh):
        self._open(n_slots, mesh, 1,
                   lambda n, dev: _RefStream(n, device=dev))


def _pool(kind, ref):
    if kind == "sharded":
        mesh = make_mesh(["cpu", "cpu"])
        return (_RefSharded(B, mesh) if ref
                else ShardedStreamDecoder(B, mesh))
    cls, kw = {"mpeg1": (StreamDecoder, {}),
               "lsf": (StreamDecoder, {"family": 1, "exact": True}),
               "sparse": (SparseStreamDecoder, {}),
               "layer2": (L12StreamDecoder, {"layer": 2}),
               "frames2": (StreamDecoder, {"frames_per_step": 2})}[kind]
    if ref:
        cls = {StreamDecoder: _RefStream, SparseStreamDecoder: _RefSparse,
               L12StreamDecoder: _RefL12}[cls]
    return cls(B, device="cpu", **kw)


def _stream(kind, n_frames, seed):
    if kind == "layer2":
        return mp3gen.make_l12_stream(layer=2, n_frames=n_frames, seed=seed,
                                      bitrate_index=8 + seed % 5,
                                      mode=3 if seed % 2 else 0)
    family = 1 if kind == "lsf" else 0
    return mp3gen.make_stream(n_frames=n_frames, seed=seed, family=family,
                              bitrate_index=11 if family else 9,
                              blocks=["long", "short", "mixed",
                                      "varied"][seed % 4],
                              mode=[0, 1, 3][seed % 3], mode_extension=2)


def _feeds(kind):
    """{step: [(slot, bytes)]}, and the stream a slot joins (Layer III
    pools; None for Layer II, whose pool has no join).  The slot fed
    again gets a mono stream; Layer II's meta (nch, rate, layer,
    family) is a stream's own, so there it runs one frame: the idle
    step after it must keep the mono stream's meta, not the one that
    its buffer held two steps before."""
    short = 2 if kind == "frames2" else 1
    lengths = [4 * short + 2, 6 * short + 3, 9 * short + 2, 12 * short + 4]
    again = 1 if kind == "layer2" else 5 * short + 2
    feeds = {0: [(s, _stream(kind, n, 800 + s))
                 for s, n in enumerate(lengths)],
             REFEED_STEP: [(REFED, _stream(kind, again, 821))]}
    join = None if kind == "layer2" else _stream(kind, 40, 830)
    return feeds, join


def _pools(dec):
    return getattr(dec, "pools", [dec])


def _snapshot(dec):
    return (dec.active.copy(), dec.meta.copy(),
            [dec.nch(s) for s in range(B)])


def _recording(on: bool):
    """A profiler session, in which the recorder counts, or nothing."""
    return (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if on
        else contextlib.nullcontext())


def _drive(kind, ref, feeds, join_stream):
    """STEPS steps of parse_step + decode_step: per step the parse's
    count, the views after the parse, the wire bytes uploaded, the PCM,
    the views after the decode, the recorder's pool.meta_kept (the pool
    under test runs in a profiler session) and whether advance left both
    host buffers as they were."""
    dec = _pool(kind, ref)
    uploads, untouched = [], []
    for pool in _pools(dec):
        up, adv = pool.upload, pool.advance

        def upload(up=up):
            wire = up()
            uploads.append(wire.numpy().tobytes())
            return wire

        def advance(wire, pool=pool, adv=adv):
            before = [w.numpy().tobytes() for w in pool._wires_t]
            pcm = adv(wire)
            untouched.append([w.numpy().tobytes() for w in pool._wires_t]
                             == before)
            return pcm
        pool.upload, pool.advance = upload, advance
    steps, join = [], None
    trace.RECORDER.reset()
    with _recording(not ref):
        for t in range(STEPS):
            for slot, data in feeds.get(t, []):
                assert dec.feed(slot, data) == 0
            if t == JOIN_STEP and join_stream is not None:
                join = dec.join(JOINED, join_stream, 0.05)
            if join is not None:
                join.pump()
            kept = trace.RECORDER.counts["pool.meta_kept"]
            n = dec.parse_step()
            kept = trace.RECORDER.counts["pool.meta_kept"] - kept
            parsed = _snapshot(dec)
            del uploads[:], untouched[:]
            pcm = dec.decode_step()
            steps.append(dict(n=n, kept=kept, parsed=parsed, pcm=pcm,
                              uploads=list(uploads),
                              untouched=list(untouched),
                              decoded=_snapshot(dec)))
    trace.RECORDER.reset()
    return dec, steps


@pytest.fixture(scope="module", params=KINDS)
def runs(request):
    kind = request.param
    feeds = _feeds(kind)
    return kind, _drive(kind, True, *feeds), _drive(kind, False, *feeds)


def _same_views(a, b, what):
    np.testing.assert_array_equal(a[0], b[0], err_msg=f"{what}: active")
    np.testing.assert_array_equal(a[1], b[1], err_msg=f"{what}: meta")
    assert a[2] == b[2], f"{what}: nch"


def test_the_feeds_churn(runs):
    """Slots go idle mid-run and come back, one is never active, the
    joined slot becomes active after its join: the carry has rows to
    keep."""
    kind, _, (dec, steps) = runs
    F = getattr(dec, "F", 1)
    act = np.stack([s["parsed"][0].reshape(F, B).any(0) for s in steps])
    assert not act[:, NEVER_FED].any()
    ended = [s for s in range(4) if act[0, s] and not act[-1, s]]
    assert len(ended) >= 2, act
    assert act[REFEED_STEP:, REFED].any() and not act[REFEED_STEP - 1, REFED]
    if kind != "layer2":
        assert not act[:JOIN_STEP, JOINED].any() and act[:, JOINED].any()
    assert len({int(s["n"]) for s in steps}) >= 3


def test_the_uploaded_wire_is_the_reference_carrys(runs):
    """Every step uploads the reference pool's wire byte for byte, idle
    slot-frames included, and decodes it to the same PCM."""
    kind, (_, want), (_, got) = runs
    for t, (w, g) in enumerate(zip(want, got)):
        assert g["n"] == w["n"], t
        assert len(g["uploads"]) == len(w["uploads"]), t
        for k, (gu, wu) in enumerate(zip(g["uploads"], w["uploads"])):
            assert gu == wu, (kind, t, k)
        assert (g["pcm"] is None) == (w["pcm"] is None), t
        if w["pcm"] is not None:
            np.testing.assert_array_equal(g["pcm"], w["pcm"],
                                          err_msg=f"{kind} step {t}")
    assert sum(len(s["uploads"]) for s in got) > STEPS // 2


def test_views_between_steps_are_the_reference_carrys(runs):
    """active, meta and nch read the same after each parse and after
    each decode as the reference's: after the decode, the step just
    decoded."""
    kind, (_, want), (_, got) = runs
    for t, (w, g) in enumerate(zip(want, got)):
        _same_views(g["parsed"], w["parsed"], f"{kind} step {t} parsed")
        _same_views(g["decoded"], w["decoded"], f"{kind} step {t} decoded")


def test_advance_writes_neither_host_buffer(runs):
    """The reference's advance writes the other buffer's active and
    meta; the pool's writes no host byte."""
    kind, (_, want), (_, got) = runs
    assert all(all(s["untouched"]) for s in got)
    assert not all(all(s["untouched"]) for s in want)


def test_meta_kept_counts_the_idle_slot_frames(runs):
    """pool.meta_kept grows by the parse step's idle slot-frames, every
    step."""
    kind, _, (dec, got) = runs
    F = getattr(dec, "F", 1)
    assert [s["kept"] for s in got] == [F * B - s["n"] for s in got]
    assert all(s["kept"] > 0 for s in got)


@pytest.mark.parametrize("kind", KINDS)
def test_no_meta_is_kept_with_every_slot_active(kind):
    """With every slot fed and active, a parse step keeps no meta row."""
    dec = _pool(kind, False)
    for s in range(B):
        assert dec.feed(s, _stream(kind, 12, 860 + s)) == 0
    kept = []
    trace.RECORDER.reset()
    with _recording(True):
        for _ in range(2):
            assert dec.parse_step() == getattr(dec, "F", 1) * B
            kept.append(trace.RECORDER.counts["pool.meta_kept"])
            dec.decode_step()
    trace.RECORDER.reset()
    assert kept == [0, 0]
