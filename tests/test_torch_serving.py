"""The port's serving runtime (pdmp3_tpu_torch/runtime/scheduler.py) on
the CPU: against the JAX StreamDecoder(kernel="pallas") on the same feed
schedule, against the native scalar decoder per slot, and across a
checkpoint the JAX decoder saved.

Tolerance: fast mode, the fast contract, at most 1 LSB on fewer than 1%
of samples (the port and JAX fast differ only in f32 summation order and
the <= 2 ulp pow43 table difference; the native decoder is the
bit-exact scalar C++ reference).  Exact mode, and the port's own
checkpoint round trip, bitwise.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdmp3_tpu.host import native_decode_file
from pdmp3_tpu.runtime import StreamDecoder as JaxStreamDecoder
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import StreamDecoder
from test_torch_fused_step import assert_pcm_contract

N = 6
MONO = 4   # corpus index of the mono stream
# GPU clock cycles of the device-side wait queued before each upload in
# the CUDA serving test (~0.1 s at H100 clocks): far longer than the
# host's parse of N slots, so the device stays behind the host
SLEEP_CYCLES = 200_000_000


@pytest.fixture(scope="module")
def corpus():
    """tests/test_runtime.py's corpus: long, short, MS, mixed 32 kHz,
    mono, 48 kHz with the bit reservoir."""
    def mk(seed, **kw):
        return mp3gen.make_stream(n_frames=6, seed=seed, **kw)
    return [mk(70, blocks="long"), mk(71, blocks="short"),
            mk(72, blocks="varied", mode=1, mode_extension=2),
            mk(73, blocks="mixed", sfreq=2), mk(74, blocks="long", mode=3),
            mk(75, blocks="varied", sfreq=1, use_reservoir=True)]


def _run(decs, max_steps=40):
    """Step every decoder in lockstep; returns per-decoder lists of
    (pcm, active) per step."""
    out = [[] for _ in decs]
    for _ in range(max_steps):
        n = [d.parse_step() for d in decs]
        assert len(set(n)) == 1, n
        if n[0] == 0:
            break
        for k, d in enumerate(decs):
            out[k].append((d.decode_step(), d.active.copy()))
    return out


def _slot_pcm(steps, slot):
    return np.concatenate([p[slot] for p, a in steps if a[slot]])


def _check_vs_native(data, got, mono=False, exact=False):
    """A slot's PCM vs the native decoder over the aligned prefix (the
    native decoder emits one channel for mono; the batch duplicates):
    bitwise in exact mode, else the fast contract."""
    want = np.frombuffer(native_decode_file(data), "<i2")
    if mono:
        np.testing.assert_array_equal(got[:, 0], got[:, 1])
    a = got[:, 0] if mono else got.reshape(-1)
    n = min(len(a), len(want))
    assert n >= len(want) - 2 * 1152 * (1 if mono else 2)
    if exact:
        np.testing.assert_array_equal(a[:n], want[:n])
    else:
        assert_pcm_contract(a[:n], want[:n])


def test_port_serving_matches_jax_pallas_and_native(corpus):
    tdec = StreamDecoder(N, device="cpu")
    jdec = JaxStreamDecoder(N, kernel="pallas")
    for s, data in enumerate(corpus):
        assert tdec.feed(s, data) == 0
        assert jdec.feed(s, data) == 0
    tsteps, jsteps = _run([tdec, jdec])
    assert len(tsteps) >= 5
    for (pt, at), (pj, aj) in zip(tsteps, jsteps):
        np.testing.assert_array_equal(at, aj)
        assert pt.shape == (N, 1152, 2) and pt.dtype == np.int16
        assert_pcm_contract(pt, pj)
        assert not pt[at == 0].any()
    for s, data in enumerate(corpus):
        _check_vs_native(data, _slot_pcm(tsteps, s), s == MONO)


def test_jax_checkpoint_restored_into_port_continues(corpus):
    jdec = JaxStreamDecoder(N, kernel="pallas")
    for s, data in enumerate(corpus):
        jdec.feed(s, data)
    head = _run([jdec], max_steps=2)[0]
    ckpt = jdec.save_checkpoint()
    tdec = StreamDecoder(N, device="cpu")
    tdec.restore_checkpoint(ckpt)
    tail_t, tail_j = _run([tdec, jdec])
    assert len(tail_t) >= 2
    for (pt, _), (pj, _) in zip(tail_t, tail_j):
        assert_pcm_contract(pt, pj)
    for s, data in enumerate(corpus):
        _check_vs_native(data, _slot_pcm(head + tail_t, s), s == MONO)


def test_port_checkpoint_round_trip_is_bitwise(corpus):
    a = StreamDecoder(N, device="cpu")
    for s, data in enumerate(corpus):
        a.feed(s, data)
    _run([a], max_steps=2)
    b = StreamDecoder(N, device="cpu")
    b.restore_checkpoint(a.save_checkpoint())
    ta, tb = _run([a, b])
    assert len(ta) >= 2
    for (pa, _), (pb, _) in zip(ta, tb):
        np.testing.assert_array_equal(pa, pb)


def test_garbage_stream_isolated(corpus):
    """A garbage stream occupies a slot without perturbing its neighbour."""
    dec = StreamDecoder(2, device="cpu")
    dec.feed(0, corpus[2])
    dec.feed(1, bytes([0x31] * 4096))
    steps = _run([dec])[0]
    _check_vs_native(corpus[2], _slot_pcm(steps, 0))


@pytest.mark.cuda
def test_cuda_serving_with_device_behind_host(corpus):
    """The pinned double-buffered upload on the card, with the device
    held behind the host: a wait queued before each step's upload keeps
    every upload pending while the host parses the next step and carries
    this step's active/meta into the other buffer.  With fetch=False and
    no sync until the end, every slot must still match the CPU decoder
    and the native one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cdec = StreamDecoder(N, device="cpu")
    gdec = StreamDecoder(N, device="cuda")
    for s, data in enumerate(corpus):
        cdec.feed(s, data)
        gdec.feed(s, data)
    csteps = _run([cdec])[0]
    gsteps = []
    for _ in range(len(csteps) + 1):
        if gdec.parse_step() == 0:
            break
        torch.cuda._sleep(SLEEP_CYCLES)
        gsteps.append((gdec.decode_step(fetch=False), gdec.active.copy()))
    # the device was still behind the host when the loop ended
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert len(gsteps) == len(csteps) >= 5
    gsteps = [(p.cpu().numpy(), a) for p, a in gsteps]
    for (pg, ag), (pc, ac) in zip(gsteps, csteps):
        np.testing.assert_array_equal(ag, ac)
        assert_pcm_contract(pg, pc)
        assert not pg[ag == 0].any()
    for s, data in enumerate(corpus):
        _check_vs_native(data, _slot_pcm(gsteps, s), s == MONO)


def test_exact_serving_matches_jax_pallas_and_native_bitwise(corpus):
    tdec = StreamDecoder(N, exact=True, device="cpu")
    jdec = JaxStreamDecoder(N, exact=True, kernel="pallas")
    for s, data in enumerate(corpus):
        assert tdec.feed(s, data) == 0
        assert jdec.feed(s, data) == 0
    tsteps, jsteps = _run([tdec, jdec])
    assert len(tsteps) >= 5
    for (pt, at), (pj, aj) in zip(tsteps, jsteps):
        np.testing.assert_array_equal(at, aj)
        np.testing.assert_array_equal(pt, pj)
    for s, data in enumerate(corpus):
        _check_vs_native(data, _slot_pcm(tsteps, s), s == MONO, exact=True)


def test_jax_exact_checkpoint_restored_into_port_continues_bitwise(corpus):
    jdec = JaxStreamDecoder(N, exact=True, kernel="pallas")
    for s, data in enumerate(corpus):
        jdec.feed(s, data)
    head = _run([jdec], max_steps=2)[0]
    ckpt = jdec.save_checkpoint()
    tdec = StreamDecoder(N, exact=True, device="cpu")
    tdec.restore_checkpoint(ckpt)
    tail_t, tail_j = _run([tdec, jdec])
    assert len(tail_t) >= 2
    for (pt, _), (pj, _) in zip(tail_t, tail_j):
        np.testing.assert_array_equal(pt, pj)
    for s, data in enumerate(corpus):
        _check_vs_native(data, _slot_pcm(head + tail_t, s), s == MONO,
                         exact=True)


@pytest.mark.cuda
def test_cuda_exact_serving_with_device_behind_host(corpus):
    """Exact serving (K2) on the card with the device held behind the
    host, as test_cuda_serving_with_device_behind_host: every slot
    bitwise equal to the CPU decoder and to the native one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cdec = StreamDecoder(N, exact=True, device="cpu")
    gdec = StreamDecoder(N, exact=True, device="cuda")
    for s, data in enumerate(corpus):
        cdec.feed(s, data)
        gdec.feed(s, data)
    csteps = _run([cdec])[0]
    gsteps = []
    for _ in range(len(csteps) + 1):
        if gdec.parse_step() == 0:
            break
        torch.cuda._sleep(SLEEP_CYCLES)
        gsteps.append((gdec.decode_step(fetch=False), gdec.active.copy()))
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert len(gsteps) == len(csteps) >= 5
    gsteps = [(p.cpu().numpy(), a) for p, a in gsteps]
    for (pg, ag), (pc, ac) in zip(gsteps, csteps):
        np.testing.assert_array_equal(ag, ac)
        np.testing.assert_array_equal(pg, pc)
    for s, data in enumerate(corpus):
        _check_vs_native(data, _slot_pcm(gsteps, s), s == MONO, exact=True)


@pytest.mark.parametrize("kw", [dict(float_pcm=True, family=1),
                                dict(resample_to=48000)])
def test_unported_options_raise(kw):
    """Every option of the JAX StreamDecoder is ported
    (tests/test_torch_float_pcm.py, tests/test_torch_resample.py); the
    combinations the JAX package refuses raise ValueError: float PCM on
    an LSF pool, resample_to without sample_rate."""
    with pytest.raises(ValueError):
        StreamDecoder(2, device="cpu", **kw)


def test_port_imports_no_jax():
    """One fast and one exact CPU step through the port, and an exact
    decode_file through TorchDSP on the port's own streaming API, in a
    fresh interpreter leave JAX and the JAX package out of
    sys.modules."""
    code = (
        "import sys\n"
        "import pdmp3_tpu_torch as P\n"
        "from pdmp3_tpu_torch.api import decode_file\n"
        "from pdmp3_tpu_torch.testing import mp3gen\n"
        "s = mp3gen.make_stream(n_frames=3, seed=5)\n"
        "for exact in (False, True):\n"
        "    d = P.StreamDecoder(1, exact=exact, device='cpu')\n"
        "    d.feed(0, s)\n"
        "    assert d.parse_step() == 1\n"
        "    pcm = d.decode_step()\n"
        "    assert pcm.shape == (1, 1152, 2) and pcm.any()\n"
        "assert decode_file(s, dsp=P.TorchDSP(device='cpu'))\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules\n"
        "                                        if 'jax' in m)\n"
        "assert not [m for m in sys.modules if m == 'pdmp3_tpu'\n"
        "            or m.startswith('pdmp3_tpu.')]\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
