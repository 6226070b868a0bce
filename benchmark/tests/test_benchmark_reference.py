"""The benchmark's yardstick: its streams (LAME's output at its
defaults, read by the harness's own side-information reader), the plain
reference against the program's native decoder and its shortcut over
looped streams against a decode of the looped bytes, the byte
arithmetic and the trace's arithmetic."""
import json

import numpy as np
import pytest

from benchmark import corpus, roofline
from benchmark.readers import layer3 as L3
from benchmark.reference import layer3 as R
from benchmark.reference.frontend import Frontend
from benchmark.reference import tables as T

# the streams of each configuration, their family and LAME's defaults
STREAMS = {"lame_44k1_stereo": (0, {"kbps": 128, "mpeg_version": "1"}),
           "lame_22k05_stereo": (1, {"kbps": 64, "mpeg_version": "2"})}


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("k", [0, 63])
def test_reference_equals_the_native_decoder(name, k):
    """0 LSB against pdmp3_tpu_torch.host.native_decode_file (bit-exact
    with the reference C decoder) over a segment looped once."""
    from pdmp3_tpu_torch.host import PROFILE_LSF, native_decode_file
    s = corpus.load(name)[0][k]
    fam = STREAMS[name][0]
    native = np.frombuffer(native_decode_file(
        s * 2, profile=PROFILE_LSF if fam else 0), np.int16)
    spf = 576 if fam else 1152
    n = len(native) // (2 * spf)
    assert n >= 32
    ref = R.decode_frames(s * 3, n, fam)
    assert np.array_equal(ref.reshape(-1), native[:n * spf * 2])


@pytest.mark.parametrize("name", STREAMS)
def test_periods_equal_a_decode_of_the_looped_bytes(name):
    """Three passes and more over a loop whose count1 table B pointer
    carries from pass to pass: the first pass is not the second, and
    every later one is."""
    s = corpus.load(name)[0][62 if name == "lame_44k1_stereo" else 5]
    fam = STREAMS[name][0]
    off = [f["offset"] for f in L3.frames(s)]
    first, second = R.periods(s, off, 0, {"family": fam})
    got = R.decode_frames(s * 5, 4 * len(off) + 3, fam)
    want = second[(np.arange(len(got)) - len(off)) % len(off)]
    want[:len(off)] = first
    assert np.array_equal(got, want), name


@pytest.mark.parametrize("name", STREAMS)
def test_streams_are_lame_at_its_defaults(name):
    """The bytes are the ones described; each segment is 32 whole frames
    of LAME's default for the format (CBR, joint stereo), entered only at
    its first frame; the recorded content is what the frames say, with
    frames coded nearly full (today's testing/mp3gen: 68% at 128 kbps)."""
    segs, info = corpus.load(name)
    fam, want = STREAMS[name]
    assert {k: info["encoder"][k] for k in want} == want
    assert info["encoder"]["mode"] == "joint stereo"
    fs = [L3.frames(s) for s in segs]
    assert len(segs) == 64 and {len(f) for f in fs} == {32}
    assert all(f[0]["main_data_begin"] == 0 for f in fs)
    assert {tuple(i for i, fr in enumerate(f) if fr["entry"])
            for f in fs} == {(0,)}
    assert {(fr["kbps"], fr["sample_rate"]) for f in fs for fr in f} == {
        (want["kbps"], info["sample_rate"])}
    st = L3.stats(fs)
    assert json.loads(json.dumps(st)) == info["stats"]
    assert st["fill"] > 0.95 and st["big_values_max"] > 200
    assert st["block_share"]["short"] > 0 and 0 < st["ms_frame_share"] < 1


@pytest.mark.parametrize("name", STREAMS)
def test_side_information_as_the_reference_reads_it(name):
    s = corpus.load(name)[0][7]
    fam = STREAMS[name][0]
    fe = Frontend(lsf=bool(fam))
    fe.feed(s[:8000])
    for f in L3.frames(s)[:12]:
        res, fd = fe.read_frame()
        assert res == T.OK
        side, ngr = fd.side, 1 if fam else 2
        assert f["main_data_begin"] == side.main_data_begin
        assert f["ms"] == bool(fd.header.mode == 1
                               and fd.header.mode_extension & 2)
        got = [(g["part2_3_length"], g["big_values"], g["block_type"])
               for g in f["granules"]]
        assert got == [(side.part2_3_length[gr][ch], side.big_values[gr][ch],
                        side.block_type[gr][ch])
                       for gr in range(ngr) for ch in range(2)]


def test_tf32_control_rounds_to_ten_mantissa_bits():
    x = np.array([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-10,
                  -(1.0 + 2.0**-11)], np.float32)
    assert R._tf32(x).tolist() == [1.0, 1.0 + 2.0**-9, 1.0 + 2.0**-10,
                                   -1.0]


def test_granule_launch_bytes_at_8192_slots():
    """PERF.md's K1 and K3 bounds: 242 MB and 243 MB a launch."""
    assert roofline.granule_launch_bytes(8192, 8192) == 242_352_128
    assert roofline.granule_launch_bytes(8192, 8192, lsf=True) == 243_400_704
    assert (roofline.granule_launch_bytes(8192, 0)
            == 8192 * (4 + 2304))


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_and_lost_launches():
    from benchmark import trace
    ev = [_x("user_annotation", "window", 100.0, 1000.0),
          _x("user_annotation", "parse", 100.0, 400.0),
          _x("user_annotation", "step_call", 500.0, 100.0),
          _x("kernel", "void (anonymous namespace)::k<false>(int)", 500.0,
             60.0),
          _x("kernel", "void (anonymous namespace)::k<false>(int)", 550.0,
             60.0),
          _x("gpu_memcpy", "Memcpy HtoD", 40.0, 80.0),
          _x("user_annotation", "deliver", 700.0, 400.0)]
    s = trace.summarize(ev, "k<false>")
    assert s["launches"] == 2 and s["kernel_s"] == pytest.approx(120e-6)
    assert s["kernels_s"] == pytest.approx(120e-6)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((20 + 110) * 1e-6)
    idle = dict(s["idle_gaps"])
    assert idle["parse"] == pytest.approx(380e-6)
    assert idle["deliver"] == pytest.approx(490e-6)
    trace.verify(s, 2, "k<false>")
    with pytest.raises(trace.LostLaunches):
        trace.verify(s, 3, "k<false>")


@pytest.mark.cuda
def test_a_traced_run_on_the_card():
    """One traced run of the MPEG-1 replay cell at a small size: the
    profiler sees every launch the port counted, and every per-layer
    metric of the cell is reported."""
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import spec
    from benchmark.run import run_cell
    from benchmark.tests.conftest import TINY
    cell = spec.cell("mp3_44k1_128k_js_fast.backend")
    out = run_cell(cell, 11, 1.0, True, torch.device("cuda", 0),
                   time.perf_counter(), dict(TINY, pool={"slots": 512}))
    assert out["correct"], out["checks"]
    assert {"decode_ms.backend", "kernel_roofline.backend",
            "device_idle_share.backend"} <= set(out["metrics"])
    assert {m["name"] for m in cell.per_layer} == set(out["metrics"])
    assert 0 < out["metrics"]["kernel_roofline.backend"]["value"] <= 100
