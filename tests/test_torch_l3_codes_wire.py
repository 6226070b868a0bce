"""The MPEG-1 pools' coded wire (host/src/wire_l3_codes.cc,
``pdmp3_parse_step_wire_l3_codes``), widened by the plain version of K10
(``ops.l3_expand.l3_expand_ref``), against the dense packer
``pdmp3_parse_step_wire16``, which stays the oracle.

Two sets of native handles take the same bytes step by step; one runs
the dense packer, the other the coded packer.  Every step: the count of
active slot-frames and ``active`` equal; ``scf_l``, ``scf_s`` and
``meta`` byte for byte (rows the packers leave alone keep their fill in
both); the widened rows of the active slot-frames equal the dense
``ix`` bit for bit, the idle ones' codes zero; each row's start the
escapes of the rows before it in slot order (then frame, granule,
channel), the list's used length their sum and nothing written past it;
and every handle left at the same input position with the same state.
Cases: the benchmark's LAME 128 kbps streams, in whole and in short
feeds; the generated corpus (long, short, mixed and start / stop blocks,
stereo, MS, intensity, MS + intensity, mono, three rates, the
reservoir); linbits escapes up to |v| = 8,206, a row of 576 escapes and
channels with part2_3_length 0; idle slots (an empty slot, streams that
end, a stray LSF frame, a frame cut off); one and two frames a step.
The packs of one step are byte-identical on 1, 3 and 8 threads.  A
pool's upload covers its escapes in whole granules, sticky upward.
``StreamDecoder``'s PCM and state on the coded wire equal the dense
wire's, fast, exact, float PCM and frame-fused (K5's route), at one and
two frames a step.

On the card (``cuda``-marked): K10 bit for bit against the plain version
at B = 12,800 and F = 2, one launch a call, and one launch a step of an
MPEG-1 pool.
"""
import ctypes as C
import os
import random

import numpy as np
import pytest
import torch

from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
from pdmp3_tpu_torch.host import NativePDMP3, lib
from pdmp3_tpu_torch.models import decoder as M
from pdmp3_tpu_torch.ops import l3_expand as X
from pdmp3_tpu_torch.ops import launch as LA
from pdmp3_tpu_torch.testing import l3wire, mp3gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAME = os.path.join(REPO, "benchmark", "streams", "lame_44k1_stereo.mp3")
# what both packers' untouched scf_l / scf_s / meta rows hold, and what
# the coded packer must leave past the escapes it writes
FILL = -7
ESC_FILL = 0x5A5A
SHARED = ("scf_l", "scf_s", "meta")


def _ptr(a):
    return a.ctypes.data_as(C.c_void_p)


def _handles(n: int) -> list:
    out = []
    for _ in range(n):
        h = NativePDMP3()
        h.open_feed()
        out.append(h)
    return out


def _dense_packer():
    fn = lib().pdmp3_parse_step_wire16
    fn.argtypes = [C.c_void_p, C.c_size_t, C.c_int, C.c_size_t] \
        + [C.c_void_p] * 5
    return fn


def _coded_packer():
    fn = lib().pdmp3_parse_step_wire_l3_codes
    fn.argtypes = ([C.c_void_p, C.c_size_t, C.c_int, C.c_size_t]
                   + [C.c_void_p] * 7 + [C.POINTER(C.c_longlong)])
    return fn


def pack_coded(arr, B: int, F: int, threads: int):
    """One coded pack: (active slot-frames, the wire uint8 [total], the
    escapes written); the escape list filled with ESC_FILL first."""
    buf = torch.zeros(M.codes_layout(B, F)["total"], dtype=torch.uint8)
    w = {k: v.numpy() for k, v in M.codes_sections(buf, B, F).items()}
    for name in SHARED:
        w[name][:] = FILL
    w["esc"][:] = ESC_FILL
    used = C.c_longlong(-1)
    n = _coded_packer()(arr, B, threads, F,
                        *(_ptr(w[k]) for k in ("codes", "starts", "scf_l",
                                               "scf_s", "meta", "active",
                                               "esc")), C.byref(used))
    return n, buf, used.value


def pack_dense(arr, B: int, F: int, threads: int = 1):
    """One dense pack: (active slot-frames, the wire int16 [total])."""
    buf = torch.zeros(M.soa_layout(B, F)["total"], dtype=torch.int16)
    w = {k: v.numpy() for k, v in M.wire_sections(buf, B, F).items()}
    for name in SHARED:
        w[name][:] = FILL
    n = _dense_packer()(arr, B, threads, F,
                        *(_ptr(w[k]) for k in ("ix", "scf_l", "scf_s",
                                               "meta", "active")))
    return n, buf


def check_step(coded, used: int, dense, B: int, F: int) -> dict:
    """The assertions of the module's docstring on one step's two packs;
    returns the step's escapes, its largest |line| and its rows of 576
    escapes."""
    c = M.codes_sections(coded, B, F)
    d = M.wire_sections(dense, B, F)
    assert torch.equal(c["active"], d["active"])
    for name in SHARED:
        assert torch.equal(c[name], d[name]), name
    on = (d["active"].reshape(F, 1, B, 1) != 0).expand(F, 2, B, 2)
    on = on.reshape(2 * F, B, 2)
    ix = X.l3_expand_ref(c["codes"], c["starts"], c["esc"][:max(used, 0)])
    assert torch.equal(ix[on], d["ix"][on])
    assert not c["codes"][~on].any()
    nib = torch.stack([c["codes"] & 0xF, c["codes"] >> 4], -1)
    per_row = (nib == X.ESCAPE).sum((-1, -2)).to(torch.int64)
    # the rows in slot order (then frame, granule, channel)
    order = per_row.reshape(2 * F, B, 2).permute(1, 0, 2).reshape(-1)
    starts = torch.cumsum(order, 0) - order
    assert torch.equal(c["starts"].permute(1, 0, 2).reshape(-1).long(),
                       starts)
    assert used == int(order.sum())
    assert (c["esc"][used:] == ESC_FILL).all()
    lines = d["ix"][on]
    return {"escapes": used,
            "max_abs": int(lines.abs().max()) if lines.numel() else 0,
            "full_rows": int((per_row == 576).sum())}


def serve_both(streams: list[bytes], F: int = 1, threads: int = 1,
               chunk: int = 1 << 20, max_steps: int = 400) -> dict:
    """Both packers over `streams` (None: a slot fed nothing), fed alike
    each step (at most `chunk` bytes a slot and step), until every stream
    is fed and a step finds no frame; check_step every step, the handles'
    positions and states equal.  Returns the active slot-frames, the
    escapes, the largest |line| and the rows of 576 escapes seen."""
    B = len(streams)
    old, new = _handles(B), _handles(B)
    arr_old = (C.c_void_p * B)(*[h._h for h in old])
    arr_new = (C.c_void_p * B)(*[h._h for h in new])
    pos = [0] * B
    seen = {"active": 0, "escapes": 0, "max_abs": 0, "full_rows": 0}
    for _ in range(max_steps):
        for s, data in enumerate(streams):
            n = min(chunk, old[s].inbuf_free(), len(data or b"") - pos[s])
            if n > 0:
                old[s].feed(data[pos[s]:pos[s] + n])
                new[s].feed(data[pos[s]:pos[s] + n])
                pos[s] += n
        n_old, dense = pack_dense(arr_old, B, F)
        n_new, coded, used = pack_coded(arr_new, B, F, threads)
        assert n_new == n_old
        got = check_step(coded, used, dense, B, F)
        seen["active"] += n_old
        seen["escapes"] += got["escapes"]
        seen["max_abs"] = max(seen["max_abs"], got["max_abs"])
        seen["full_rows"] += got["full_rows"]
        assert [h.inbuf_filled() for h in new] == [h.inbuf_filled()
                                                   for h in old]
        assert [h.save_state() for h in new] == [h.save_state()
                                                 for h in old]
        if n_old == 0 and all(p == len(d or b"")
                              for p, d in zip(pos, streams)):
            return seen
    raise AssertionError(f"streams not done in {max_steps} steps")


def lame_streams(n: int, frames: int = 24) -> list[bytes]:
    """The first `frames` frames of `n` of the benchmark's 64 LAME 128
    kbps joint-stereo streams (32 frames each, one after another)."""
    with open(LAME, "rb") as f:
        data = f.read()
    size = len(data) // 64
    return [data[k * 64 // n * size:][:size * frames // 32]
            for k in range(n)]


def generated(blocks: str, seed: int) -> list[bytes]:
    """Stereo, MS, intensity, MS + intensity and mono at the three
    rates, some with the reservoir."""
    kws = [dict(mode=0), dict(mode=1, mode_extension=2),
           dict(mode=1, mode_extension=1, intensity_pos=True),
           dict(mode=1, mode_extension=3, intensity_pos=True),
           dict(mode=3)]
    return [mp3gen.make_stream(n_frames=6, seed=seed + k, blocks=blocks,
                               sfreq=k % 3, use_reservoir=k % 2 == 1,
                               bitrate_index=[9, 11, 14][k % 3], **kw)
            for k, kw in enumerate(kws)]


def _zero_scf(g):
    g.scalefac_l = np.zeros(21, np.int32)
    g.scalefac_s = np.zeros((12, 3), np.int32)
    return g


def escape_rows_stream(seed: int, n: int = 4) -> bytes:
    """Mono 48 kHz 320 kbps frames whose one granule codes all 576 lines
    outside -7..7 (table 31 for the first four, 8,206, the most a
    linbits code holds; table 24 for the rest, 8-14) and whose other
    granule has part2_3_length 0."""
    rng = random.Random(seed)
    frames = []
    for f in range(n):
        loud = _zero_scf(mp3gen.GranuleSpec(
            global_gain=150, scalefac_compress=0,
            table_select=(31, 24, 24), region0_count=0, region1_count=7))
        v = np.array([rng.randrange(8, 15) for _ in range(576)], np.int64)
        v[:4] = 8206
        loud.values = v * np.array([rng.choice((-1, 1))
                                    for _ in range(576)])
        loud.big_values = 288
        quiet = _zero_scf(mp3gen.GranuleSpec(scalefac_compress=0))
        quiet.values = np.zeros(576, np.int64)
        grans = [[loud, loud], [quiet, quiet]][::1 - 2 * (f % 2)]
        frames.append(mp3gen.FrameSpec(
            bitrate_index=14, sampling_frequency=1, mode=3,
            granules=grans, scfsi=np.zeros((2, 4), np.int32)))
    return mp3gen.assemble_stream(frames, rng=rng, use_reservoir=False)


# ---- the packer against the dense one ---------------------------------------

@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("chunk", [1 << 20, 1500])
def test_lame_streams(chunk, F):
    """The benchmark's LAME streams (long, start, short and stop blocks,
    MS or LR by frame, the reservoir), whole and in 1,500-byte feeds."""
    seen = serve_both(lame_streams(6), F, chunk=chunk)
    assert seen["active"] >= 6 * 18 and seen["escapes"] > 0


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("blocks", ["long", "short", "mixed", "varied"])
def test_generated_corpus(blocks, F):
    """testing/mp3gen.py streams of each block kind ("varied": long,
    start, short, stop and mixed in turn) in stereo, MS, intensity, MS +
    intensity and mono at 44.1, 48 and 32 kHz."""
    seen = serve_both(generated(blocks, 300), F)
    assert seen["active"] >= 5 * 4


@pytest.mark.parametrize("F", [1, 2])
def test_linbits_escapes_and_full_rows(F):
    """Rows of 576 escapes with lines of 8,206, channels with
    part2_3_length 0, and generated streams at the linbits limit."""
    loud = [mp3gen.make_stream(n_frames=6, seed=80 + k, blocks=b, amp=8206,
                               bitrate_index=14, mode=m)
            for k, (b, m) in enumerate([("long", 0), ("short", 1),
                                        ("varied", 3), ("mixed", 0)])]
    seen = serve_both([escape_rows_stream(1), escape_rows_stream(2)] + loud,
                      F)
    assert seen["max_abs"] == 8206
    assert seen["full_rows"] >= 2 * 3


@pytest.mark.parametrize("F", [1, 2])
def test_idle_slots(F):
    """An empty slot, streams of other lengths that end, a stream cut
    inside its last frame and an LSF frame inside an MPEG-1 stream: the
    idle slot-frames' codes are zero and carry no escape."""
    a, b = (mp3gen.make_stream(n_frames=n, seed=90 + n, blocks="varied",
                               mode=1, mode_extension=2) for n in (3, 7))
    lsf = mp3gen.make_stream(n_frames=1, seed=95, family=1)
    seen = serve_both([a, None, b[:-40], b[:len(b) // 2] + lsf
                       + b[len(b) // 2:], b], F)
    assert 0 < seen["active"] < 3 + 7 * 3


def test_threads_pack_byte_identical():
    """70 slots (past the packer's one-thread bound of 64) at one and two
    frames a step: the whole wire up to the escapes' end byte for byte
    on 1, 3 and 8 threads, and the same escape count."""
    streams = lame_streams(35) + [s for k in range(7)
                                  for s in generated("varied", 400 + 10 * k)]
    B = len(streams)
    for F in (1, 2):
        sets = [_handles(B) for _ in range(3)]
        arrs = [(C.c_void_p * B)(*[h._h for h in hs]) for hs in sets]
        for hs in sets:
            for h, d in zip(hs, streams):
                h.feed(d[:h.inbuf_free()])
        fixed = M.codes_layout(B, F)["fixed"]
        for _ in range(4):
            packs = [pack_coded(arr, B, F, t)
                     for arr, t in zip(arrs, (1, 3, 8))]
            n, buf, used = packs[0]
            assert n > 0 and used > 0
            for n2, buf2, used2 in packs[1:]:
                assert (n2, used2) == (n, used)
                assert torch.equal(buf2[:fixed + 2 * used],
                                   buf[:fixed + 2 * used])


# ---- the pool ---------------------------------------------------------------

def test_pool_upload_is_sticky(monkeypatch):
    """A pool uploads the fixed sections and its escapes rounded up to
    whole ESCAPE_GRANULEs (the worst case at most), never fewer than any
    step before, the list zero past the step's escapes up to there; the
    uploaded wire's widened lines are the dense packer's."""
    monkeypatch.setattr(StreamDecoder, "ESCAPE_GRANULE", 256)
    # two slots start loud (rows of 576 escapes) at step 2
    streams = lame_streams(6, frames=8) + [escape_rows_stream(5, n=2)] * 2
    start = [0] * 6 + [2, 2]
    dec = StreamDecoder(8, device="cpu")
    lay = M.codes_layout(8, 1)
    assert lay["fixed"] + 2 * lay["cap"] == lay["total"]
    old = _handles(8)
    arr = (C.c_void_p * 8)(*[h._h for h in old])
    pos = [0] * 8
    sizes = []
    for step in range(6):
        for s, d in enumerate(streams):
            n = min(dec.inbuf_free(s), len(d) - pos[s])
            if step >= start[s] and n > 0:
                dec.feed(s, d[pos[s]:pos[s] + n])
                old[s].feed(d[pos[s]:pos[s] + n])
                pos[s] += n
        n = dec.parse_step()
        n_old, dense = pack_dense(arr, 8, 1)
        assert n == n_old
        bucket = (dec.wire_bytes() - lay["fixed"]) // 2
        used = dec._esc_used.value
        assert used <= bucket <= lay["cap"]
        assert bucket % 256 == 0 or bucket == lay["cap"]
        assert not dec.esc[used:bucket].any()
        sizes.append(dec.wire_bytes())
        wire = dec.upload()
        assert wire.shape == (dec.wire_bytes(),)
        got = M.wire_sections(l3wire.dense_wire(wire, 8), 8)
        want = M.wire_sections(dense, 8)
        on = (want["active"] != 0).reshape(1, 8, 1).expand(2, 8, 2)
        assert torch.equal(got["ix"][on], want["ix"][on])
        dec.advance(wire)
    assert sizes == sorted(sizes) and sizes[1] < sizes[2] == sizes[-1]
    assert sizes[2] > lay["fixed"] + 2 * 2 * 576   # the loud step


def _serve_pools(streams, F, exact=False, float_pcm=False):
    """A coded pool and a second set of handles whose dense packs decode
    by decode_frame_packed on a state of their own, fed alike; each
    step's PCM and the states bit for bit.  Returns the active
    slot-frames."""
    B = len(streams)
    dec = StreamDecoder(B, exact=exact, float_pcm=float_pcm,
                        frames_per_step=F, device="cpu")
    old = _handles(B)
    arr = (C.c_void_p * B)(*[h._h for h in old])
    st = M.init_state(B, "cpu")
    pos = [0] * B
    total = 0
    for _ in range(200):
        for s, data in enumerate(streams):
            n = min(dec.inbuf_free(s), len(data) - pos[s])
            if n > 0:
                dec.feed(s, data[pos[s]:pos[s] + n])
                old[s].feed(data[pos[s]:pos[s] + n])
                pos[s] += n
        n = dec.parse_step()
        n_old, dense = pack_dense(arr, B, F)
        assert n == n_old
        if n == 0:
            return total
        total += n
        got = dec.decode_step()
        want, st = M.decode_frame_packed(dense, st, B=B, F=F, exact=exact,
                                         float_pcm=float_pcm)
        np.testing.assert_array_equal(got.view(np.uint8) if float_pcm
                                      else got,
                                      want.numpy().view(np.uint8)
                                      if float_pcm else want.numpy())
        for name in ("store", "v_blocks", "prev_lines"):
            a, b = getattr(dec.state, name), getattr(st, name)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                name
    raise AssertionError("streams not done in 200 steps")


@pytest.mark.parametrize("route,F", [("fast", 1), ("fast", 2), ("exact", 1),
                                     ("float", 1), ("frame_fused", 1)])
def test_pool_equals_the_dense_wire(route, F, monkeypatch):
    """StreamDecoder on the coded wire against the dense packer's wire
    through decode_frame_packed: PCM and state bit for bit every step,
    with streams that end early (idle slot-frames) and loud rows."""
    if route == "frame_fused":
        monkeypatch.setattr(M, "_FRAME_FUSED", True)
    streams = (generated("varied", 500)[:3] + lame_streams(2, frames=10)
               + [escape_rows_stream(7, n=3)])
    assert _serve_pools(streams, F, exact=route == "exact",
                        float_pcm=route == "float") > 0


# ---- the widening -----------------------------------------------------------

def random_dense_wire(B: int, F: int, seed: int, idle=()) -> torch.Tensor:
    """A dense wire whose rows hold small lines, a few escapes each
    (|v| up to 8,206), some rows of 576 escapes and some silent rows;
    `idle` slot-frames (f * B + s) inactive."""
    rng = np.random.default_rng(seed)
    buf = torch.zeros(M.soa_layout(B, F)["total"], dtype=torch.int16)
    w = M.wire_sections(buf, B, F)
    ix = np.clip(np.round(rng.laplace(0, 1.5, (2 * F, B, 2, 576))), -7, 7)
    mark = rng.random(ix.shape) < 0.02
    big = rng.integers(8, 8207, ix.shape) * rng.choice([-1, 1], ix.shape)
    ix = np.where(mark, big, ix)
    ix[:, ::97] = big[:, ::97]             # rows of 576 escapes
    ix[:, 5::89] = 0                       # silent rows
    w["ix"].copy_(torch.from_numpy(ix.astype(np.int16)))
    act = np.ones(F * B, np.int16)
    act[list(idle)] = 0
    w["active"].copy_(torch.from_numpy(act.reshape(w["active"].shape)))
    return buf


def test_plain_widening_round_trip():
    """coded_wire then dense_wire (the plain widening) returns the active
    rows bit for bit and zero rows for idle slot-frames; an escape code
    past the list reads 0; the CPU entry point is the plain version."""
    B, F = 37, 2
    dense = random_dense_wire(B, F, 3, idle=range(1, F * B, 5))
    coded = l3wire.coded_wire(dense, B, F)
    back = M.wire_sections(l3wire.dense_wire(coded, B, F), B, F)
    want = M.wire_sections(dense, B, F)
    on = (want["active"].reshape(F, 1, B, 1) != 0).expand(F, 2, B, 2)
    on = on.reshape(2 * F, B, 2)
    assert torch.equal(back["ix"][on], want["ix"][on])
    assert not back["ix"][~on].any()
    c = M.codes_sections(coded, B, F)
    assert torch.equal(X.l3_expand(c["codes"], c["starts"], c["esc"]),
                       back["ix"])
    k = 500
    cut = X.l3_expand_ref(c["codes"], c["starts"], c["esc"][:k])
    nib = torch.stack([c["codes"] & 0xF, c["codes"] >> 4], -1).flatten(-2)
    mark = nib == X.ESCAPE
    at = c["starts"].unsqueeze(-1).long() + torch.cumsum(mark, -1) - 1
    past = mark & (at >= k)
    assert past.any() and (mark & ~past).any()
    assert torch.equal(cut, torch.where(past, 0, back["ix"]))
    with pytest.raises(ValueError):
        X.l3_expand(c["codes"].to(torch.int16), c["starts"], c["esc"])


@pytest.mark.cuda
def test_k10_matches_its_plain_version_at_pool_size():
    """K10 against l3_expand_ref at B = 12,800 and F = 2 with rows of
    576 escapes, silent rows and idle slot-frames: every line; one launch
    a call, into a given buffer too; then one launch a step of an MPEG-1
    pool (K1 twice a frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    B, F = 12800, 2
    dense = random_dense_wire(B, F, 11, idle=range(3, F * B, 11))
    coded = l3wire.coded_wire(dense, B, F)
    c = M.codes_sections(coded, B, F)
    want = X.l3_expand_ref(c["codes"], c["starts"], c["esc"])
    g = M.codes_sections(coded.to(dev), B, F)
    out = torch.full((2 * F, B, 2, 576), -1, dtype=torch.int16, device=dev)
    n0 = LA.LAUNCHES["l3_expand"]
    got = X.l3_expand(g["codes"], g["starts"], g["esc"], out=out)
    torch.cuda.synchronize()
    assert LA.LAUNCHES["l3_expand"] == n0 + 1 and got is out
    assert torch.equal(got.cpu(), want)
    dec = StreamDecoder(8, device=dev)
    feeder = LoopFeeder(dec, lame_streams(8))
    for _ in range(3):
        n0, k0 = LA.LAUNCHES["l3_expand"], LA.LAUNCHES["fused_granule"]
        feeder.step()
        assert dec.parse_step() == 8
        dec.decode_step()
        assert (LA.LAUNCHES["l3_expand"],
                LA.LAUNCHES["fused_granule"]) == (n0 + 1, k0 + 2)
