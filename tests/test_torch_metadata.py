"""The port's mid-stream join (StreamDecoder.join / SlotJoin), batched
file decode (runtime.decode_files_batched) and command line
(pdmp3_tpu_torch.cli with --device cpu) on the CPU, against the native
scalar decoder and the JAX package's metadata-driven decodes
(decode_file_seek, decode_file_gapless), with streams made from seeds by
mp3gen.

Tolerances: exact mode byte-equal (joined windows, batched files,
gapless and windowed files, Layer II files, CLI output).  Fast mode
joins: the fast contract, at most 1 LSB on fewer than 1% of samples.
"""
import json
import wave

import numpy as np
import pytest

from pdmp3_tpu import metadata as JM
from pdmp3_tpu.host import PROFILE_L12, PROFILE_LSF, native_decode_file
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import StreamDecoder, decode_files_batched
from pdmp3_tpu_torch.cli import main
from test_torch_fused_step import assert_pcm_contract


def _mk(seed, **kw):
    return mp3gen.make_stream(n_frames=6, seed=seed, **kw)


@pytest.fixture(scope="module")
def corpus():
    """tests/test_runtime.py's corpus."""
    return [_mk(70, blocks="long"), _mk(71, blocks="short"),
            _mk(72, blocks="varied", mode=1, mode_extension=2),
            _mk(73, blocks="mixed", sfreq=2), _mk(74, blocks="long", mode=3),
            _mk(75, blocks="varied", sfreq=1, use_reservoir=True)]


def _run_join(dec, j, slot, max_steps=80):
    """Pump a SlotJoin and collect the slot's PCM of its active steps,
    trimmed as the cursor says (stereo S16)."""
    got = []
    for _ in range(max_steps):
        j.pump()
        if dec.parse_step() == 0:
            if j.exhausted:
                break
            continue
        pcm = dec.decode_step()
        if dec.active[slot]:
            got.append(pcm[slot].tobytes())
    blob = b"".join(got)
    return blob[j.drop_samples * 4:(j.drop_samples + j.take_samples) * 4]


def _window(full: bytes, t0: float, rate: int, n: int) -> bytes:
    a = int(round(t0 * rate)) * 4
    return full[a:a + n]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_join_mid_stream(exact):
    """A slot pointed at t = 0.3 s of a new stream, beside a neighbour
    served from t = 0: the window of a full native decode, byte-equal in
    exact mode."""
    s = mp3gen.make_stream(n_frames=30, seed=80, blocks="varied", mode=1,
                           mode_extension=2, use_reservoir=True)
    full = native_decode_file(s)
    dec = StreamDecoder(2, exact=exact, device="cpu")
    dec.feed(0, _mk(81))
    t0, dur = 0.3, 0.15
    j = dec.join(1, s, t0, dur)
    window = _run_join(dec, j, 1)
    assert len(window) == j.take_samples * 4 > 0
    want = _window(full, t0, 44100, len(window))
    if exact:
        assert window == want
    else:
        assert_pcm_contract(np.frombuffer(window, "<i2"),
                            np.frombuffer(want, "<i2"))


def test_join_reused_slot():
    """A slot that served another stream joins bit-exactly without a
    device-state reset: the preroll rewrites every carry inside the
    dropped warm-up."""
    s = mp3gen.make_stream(n_frames=30, seed=82, use_reservoir=True)
    full = native_decode_file(s)
    dec = StreamDecoder(2, exact=True, device="cpu")
    dec.feed(1, _mk(83, blocks="short"))
    for _ in range(4):
        if dec.parse_step():
            dec.decode_step()
    assert dec.state.store[1].any()
    t0, dur = 0.4, 0.1
    j = dec.join(1, s, t0, dur)
    window = _run_join(dec, j, 1)
    assert len(window) == j.take_samples * 4 > 0
    assert window == _window(full, t0, 44100, len(window))


def test_join_in_a_loop_fed_pool():
    """A join in a pool fed by a LoopFeeder: the joined slot released
    from the loop, its neighbours still looping, the window bitwise."""
    from pdmp3_tpu_torch import LoopFeeder
    s = mp3gen.make_stream(n_frames=20, seed=89, use_reservoir=True)
    dec = StreamDecoder(3, exact=True, device="cpu")
    feeder = LoopFeeder(dec, [_mk(90), _mk(91, mode=3)])
    for _ in range(2):
        feeder.step()
        assert dec.parse_step() == 3
        dec.decode_step()
    feeder.release(1)
    j = dec.join(1, s, 0.2, 0.1)
    got = []
    for _ in range(30):
        feeder.step()
        j.pump()
        assert dec.parse_step() >= 2
        pcm = dec.decode_step()
        if dec.active[1]:
            got.append(pcm[1].tobytes())
    blob = b"".join(got)
    window = blob[j.drop_samples * 4:(j.drop_samples + j.take_samples) * 4]
    assert j.exhausted and len(window) == j.take_samples * 4 > 0
    assert window == _window(native_decode_file(s), 0.2, 44100, len(window))


def test_join_lsf_family():
    """A join in an MPEG-2 pool (one granule per frame)."""
    s = mp3gen.make_stream(n_frames=40, seed=84, family=1)
    full = native_decode_file(s, profile=PROFILE_LSF)
    dec = StreamDecoder(2, exact=True, family=1, device="cpu")
    t0, dur = 0.3, 0.15
    j = dec.join(0, s, t0, dur)
    window = _run_join(dec, j, 0)
    assert len(window) == j.take_samples * 4 > 0
    assert window == _window(full, t0, 22050, len(window))


def test_join_family_mismatch_raises():
    """An LSF stream joined to an MPEG-1 pool raises ValueError (the JAX
    package asserts), and the slot's handle is left as it was."""
    s = mp3gen.make_stream(n_frames=10, seed=85, family=1)
    dec = StreamDecoder(1, exact=True, device="cpu")
    dec.feed(0, _mk(86))
    with pytest.raises(ValueError):
        dec.join(0, s, 0.0)
    assert dec.parse_step() == 1
    assert dec.join(0, _mk(87), 10.0) is None   # past the end: no window


def test_batched_files_equal_native(corpus):
    got = decode_files_batched(corpus, exact=True, device="cpu")
    for i, data in enumerate(corpus):
        assert got[i] == native_decode_file(data), f"file {i}"


def test_batched_grouped_slots_and_uneven_lengths(corpus):
    """n_slots < files (round-robin groups), and files cut short that
    finish early while their neighbours go on."""
    files = [corpus[0][:1500], corpus[1], corpus[2][:2000], corpus[4]]
    got = decode_files_batched(files, n_slots=3, exact=True, device="cpu")
    for i, data in enumerate(files):
        assert got[i] == native_decode_file(data), f"file {i}"


def test_batched_gapless_and_window():
    """gapless=True and window=(start, duration): each file byte-equal to
    the JAX package's single-file metadata decode."""
    tagged = [mp3gen.make_tagged_stream(n_frames=10, seed=s,
                                        encoder_delay=576,
                                        encoder_padding=1152)[0]
              for s in (86, 87)]
    files = tagged + [mp3gen.make_stream(n_frames=12, seed=88,
                                         use_reservoir=True)]
    got = decode_files_batched(files, exact=True, gapless=True,
                               device="cpu")
    for i, f in enumerate(files):
        assert got[i] == JM.decode_file_gapless(f)[0], f"gapless file {i}"
    got = decode_files_batched(files, exact=True, window=(0.1, 0.08),
                               device="cpu")
    for i, f in enumerate(files):
        assert got[i] == JM.decode_file_seek(f, 0.1, 0.08)[0], \
            f"window file {i}"
    with pytest.raises(ValueError):
        decode_files_batched(files, gapless=True, layer=2, device="cpu")


def test_batched_layer2_files():
    files = [mp3gen.make_l12_stream(layer=2, n_frames=4, seed=s,
                                    bitrate_index=12) for s in range(2)]
    files.append(mp3gen.make_l12_stream(layer=2, n_frames=3, seed=5,
                                        bitrate_index=8, mode=3))
    got = decode_files_batched(files, exact=True, layer=2, device="cpu")
    for i, data in enumerate(files):
        want = native_decode_file(data, profile=PROFILE_L12)
        assert len(want) > 0 and got[i] == want, f"file {i}"


def test_cli_info_json(tmp_path, capsys):
    s, _ = mp3gen.make_tagged_stream(n_frames=12, seed=19)
    p = tmp_path / "a.mp3"
    p.write_bytes(s)
    assert main(["--info", str(p)]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["vbr_header"] == "xing" and d["frame_count"] == 12
    assert d["lame"]["encoder"] == "LAME3.100"


@pytest.mark.parametrize("backend", ["gpu", "gpu-fast", "batch"])
def test_cli_seek_wav(tmp_path, backend):
    """--seek/--duration --wav on the CPU: the window of a full native
    decode (gpu byte-equal; gpu-fast and batch, which decodes in fast
    precision as the JAX CLI's batch backend does, within the
    contract)."""
    s = mp3gen.make_stream(n_frames=20, seed=20)
    p = tmp_path / "a.mp3"
    p.write_bytes(s)
    out = tmp_path / "cut.wav"
    assert main(["--backend", backend, "--device", "cpu", "--seek", "0.2",
                 "--duration", "0.1", "--wav", "-o", str(out),
                 str(p)]) == 0
    with wave.open(str(out)) as w:
        assert w.getframerate() == 44100 and w.getnchannels() == 2
        got = w.readframes(w.getnframes())
    assert len(got) == int(round(0.1 * 44100)) * 4
    want = _window(native_decode_file(s), 0.2, 44100, len(got))
    if backend != "gpu":
        assert_pcm_contract(np.frombuffer(got, "<i2"),
                            np.frombuffer(want, "<i2"))
    else:
        assert got == want


def test_cli_gapless(tmp_path):
    s, n = mp3gen.make_tagged_stream(n_frames=10, seed=21,
                                     encoder_delay=576,
                                     encoder_padding=1152)
    p = tmp_path / "a.mp3"
    p.write_bytes(s)
    out = tmp_path / "a.raw"
    assert main(["--backend", "gpu-exact", "--device", "cpu", "--gapless",
                 "-o", str(out), str(p)]) == 0
    assert out.read_bytes() == JM.decode_file_gapless(s)[0]
    assert out.stat().st_size == (n * 1152 - 576 - 1152) * 4


def test_cli_layers12_and_batch(tmp_path):
    """--layers12 on the gpu backend (byte-equal), and the batch backend
    (fast) on a mono Layer III file (the fast contract), against the
    native decoder; the batch backend refuses --layers12."""
    s = mp3gen.make_l12_stream(layer=1, n_frames=4, seed=4,
                               bitrate_index=12)
    p = tmp_path / "a.mp2"
    p.write_bytes(s)
    assert main(["--backend", "gpu", "--device", "cpu", "--layers12",
                 str(p)]) == 0
    assert (tmp_path / "a.mp2.raw").read_bytes() == native_decode_file(
        s, profile=PROFILE_L12)
    m = mp3gen.make_stream(n_frames=6, seed=22, mode=3)
    q = tmp_path / "b.mp3"
    q.write_bytes(m)
    assert main(["--backend", "batch", "--device", "cpu", str(q)]) == 0
    got = np.frombuffer((tmp_path / "b.mp3.raw").read_bytes(), "<i2")
    want = np.frombuffer(native_decode_file(m), "<i2")
    assert len(got) == len(want) > 0
    assert_pcm_contract(got, want)
    with pytest.raises(SystemExit):
        main(["--backend", "batch", "--device", "cpu", "--layers12",
              str(p)])


@pytest.mark.parametrize("backend", [None, "gpu", "gpu-exact", "gpu-fast",
                                     "batch"])
def test_cli_gpu_backends_need_the_card_without_device_cpu(tmp_path,
                                                           backend):
    """Without --device cpu the gpu and batch backends, and the default
    backend (gpu), decode on the CUDA card: where PyTorch sees none they
    raise, and write nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = tmp_path / "a.mp3"
    p.write_bytes(mp3gen.make_stream(n_frames=4, seed=23))
    args = [] if backend is None else ["--backend", backend]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args + [str(p)])
    assert not (tmp_path / "a.mp3.raw").exists()


def test_cli_default_backend_is_gpu_exact(tmp_path):
    """With no --backend the CLI decodes through TorchDSP in exact mode:
    on --device cpu, byte-equal to the native decoder."""
    s = mp3gen.make_stream(n_frames=6, seed=24)
    p = tmp_path / "a.mp3"
    p.write_bytes(s)
    assert main(["--device", "cpu", str(p)]) == 0
    assert (tmp_path / "a.mp3.raw").read_bytes() == native_decode_file(s)
