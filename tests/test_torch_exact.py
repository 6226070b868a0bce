"""Exact precision in the port: the granule step on both routes (fused:
``fused_granule_step(exact=True)``; split: ``split_granule_step``, which
``decode_granules`` runs) against the JAX exact routes, the band-12
carry, the float64 rounding points, and the CUDA kernels against their
plain versions (``cuda`` marker).

Tolerance: bitwise everywhere (PCM, store, v_blocks, prev_lines, the
rounding points).  At the short-block intensity quirk the reference
gives +0.0 where the JAX XLA stage keeps -0.0 (test_torch_dsp.py); on
these fixtures that sign never reaches PCM or state.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdmp3_tpu import tables as T
from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu_torch.models.decoder import DecoderState, init_state
from pdmp3_tpu_torch.ops import back_half as BH
from pdmp3_tpu_torch.ops import dsp as TD
from pdmp3_tpu_torch.ops import fused_step as FS
from pdmp3_tpu_torch.ops import launch as LA
from pdmp3_tpu_torch.ops import rounding as R
from test_jax_decoder import _band12_zero_bits_stream
from test_pallas import _frames
from test_torch_fused_step import (IDLE_SEAMS, RAGGED_B, check_ragged_seams,
                                   wire_from_batch)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import prove_exact_emulations as P  # noqa: E402

ROUTES = {"fused": FS.fused_granule_step, "split": BH.split_granule_step}


def _state_bits(st):
    return {n: getattr(st, n).numpy().view(np.uint32).copy()
            for n in ("store", "v_blocks", "prev_lines")}


def _assert_state_bits(st, want: dict, what=""):
    """Port state vs JAX canonical state (bit patterns), bitwise."""
    for name, wb in want.items():
        np.testing.assert_array_equal(
            getattr(st, name).numpy().view(np.uint32), wb,
            err_msg=f"{what} {name}")


def _canon(jstate) -> dict:
    return {n: np.asarray(getattr(jstate, n), np.float32).view(np.uint32)
            for n in ("store", "v_blocks", "prev_lines")}


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_exact_step_matches_jax_exact_routes(route, bug_compat):
    """3 frames of the 8 streams: the port's exact step vs the JAX split
    Pallas route (K4 in interpret mode) and the XLA exact route."""
    frames = _frames(3)
    B = len(frames)
    pst = PSF.init_pallas_state(B)
    xst = JM.init_state(B)
    st = init_state(B, "cpu")
    for t in range(3):
        for batch in JM.frame_to_batches([fr[t] for fr in frames]):
            pp, pst = PSF.decode_granules_pallas(
                batch, pst, exact=True, bug_compat=bug_compat,
                block_lanes=8)
            px, xst = JM.decode_granules(batch, xst, exact=True,
                                         bug_compat=bug_compat)
            pt, st = ROUTES[route](*wire_from_batch(batch), st,
                                   bug_compat=bug_compat, exact=True)
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pp))
            np.testing.assert_array_equal(pt.numpy(), np.asarray(px))
            _assert_state_bits(st, _canon(PSF.state_from_pallas(pst)),
                               f"frame {t} vs pallas")
            _assert_state_bits(st, _canon(xst), f"frame {t} vs xla")


def test_fused_and_split_routes_bitwise_equal():
    """The two port routes agree bit for bit, state included, from a
    random starting state with idle slots."""
    frames = _frames(2)
    B = len(frames)
    rng = np.random.default_rng(1)
    st0 = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))]
    sf = DecoderState(*(torch.from_numpy(a.copy()) for a in st0))
    ss = DecoderState(*(torch.from_numpy(a.copy()) for a in st0))
    for t in range(2):
        for batch in JM.frame_to_batches([fr[t] for fr in frames]):
            ops = list(wire_from_batch(batch))
            ops[4][[1, 6]] = 0
            pf, sf = FS.fused_granule_step(*ops, sf, exact=True)
            ps, ss = BH.split_granule_step(*ops, ss, exact=True)
            assert torch.equal(pf, ps)
            _assert_state_bits(sf, _state_bits(ss))


def test_band12_zero_bits_fixture_exact():
    """The directed band-12 fixture (granule-0 lines exactly +0.0, so the
    aliased scalefactors are 0 and the gain 1): the port's exact step
    keeps prev_lines' bit pattern equal to the JAX exact route's after
    every granule, and PCM bitwise."""
    fe = Frontend()
    fe.feed(_band12_zero_bits_stream())
    fds = []
    while True:
        res, fd = fe.read_frame()
        if res != 0:
            break
        fds.append(fd)
    assert len(fds) >= 2
    pst = PSF.init_pallas_state(1)
    st = init_state(1, "cpu")
    seen_zero = False
    for fd in fds:
        for batch in JM.frame_to_batches([fd]):
            pp, pst = PSF.decode_granules_pallas(batch, pst, exact=True,
                                                 block_lanes=8)
            pt, st = FS.fused_granule_step(*wire_from_batch(batch), st,
                                           exact=True)
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pp))
            want = np.asarray(pst.prev_lines).view(np.uint32)
            np.testing.assert_array_equal(
                st.prev_lines.numpy().view(np.uint32), want)
            seen_zero |= bool((want == 0).all())
    assert seen_zero


def test_requantize_subnormal_band12_gains():
    """prev_lines holding the subnormal bit patterns 126..320 give ch1's
    short band-12 lines the true gains 2^(-q/4), subnormal for q >= 504:
    the exact requantize equals a numpy f32 computation of
    (GAIN_QUARTER_TRUE[q] * 2^((gg-210)/4)) * |x|^(4/3), denormals kept."""
    B = 65
    bits = np.arange(126, 126 + 3 * B, dtype=np.uint32).reshape(B, 3)
    prev = bits.view(np.float32)
    layout = np.full((B, 2), 1, np.int32)          # 44.1 kHz pure short
    sfs = np.zeros((B, 2), np.int32)
    sfs[::2, 1] = 1                                # qpu 2 and 4
    gg = np.full((B, 2), 230, np.int32)
    ix = np.zeros((B, 2, 576), np.int32)
    ix[:, 1] = np.arange(576) % 7 - 3
    zeros2 = np.zeros((B, 2), np.int32)
    got = TD.requantize(
        torch.from_numpy(ix), torch.zeros(B, 2, 22, dtype=torch.int32),
        torch.zeros(B, 2, 39, dtype=torch.int32), torch.from_numpy(layout),
        torch.from_numpy(gg), torch.from_numpy(sfs),
        torch.from_numpy(zeros2), torch.zeros(B, 2, 3, dtype=torch.int32),
        True, 1, torch.from_numpy(prev)).numpy()[:, 1]
    lm = T.layout_maps(0)
    m12 = (lm["is_short"][1] == 1) & (lm["sfb"][1] == 12)
    win = np.take(lm["win"][1], T.layout_maps(0)["reorder"][1])
    q = (2 << sfs[:, 1:2]) * bits.astype(np.int64)            # [B,3]
    gqt = np.asarray(T.GAIN_QUARTER_TRUE, np.float32)
    g = np.where(q < 640, gqt[np.minimum(q, 639)], np.float32(0))
    tmp2 = np.float32(2.0 ** 5)                    # (230 - 210) / 4
    x = ix[:, 1]
    tmp3 = (np.where(x < 0, np.float32(-1), np.float32(1))
            * np.asarray(T.POW43, np.float32)[np.abs(x)])
    want = ((g[np.arange(B)[:, None], win[None, :]] * tmp2)
            * tmp3).astype(np.float32)
    np.testing.assert_array_equal(got[:, m12].view(np.uint32),
                                  want[:, m12].view(np.uint32))
    sub = (want[:, m12] != 0) & (np.abs(want[:, m12])
                                 < np.finfo(np.float32).tiny)
    assert sub.sum() > 100        # the case really reaches denormal gains


def _rounding_sample() -> np.ndarray:
    """test_exact_emulations_structured's sample plus +-0.0, subnormals,
    +-inf and NaN."""
    rng = np.random.default_rng(7)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 1 << 18, dtype=np.uint64),
        rng.integers(0, 2 ** 25, 1 << 17, dtype=np.uint64),
        rng.integers(0, 2 ** 25, 1 << 17, dtype=np.uint64) + 0x80000000,
        (np.abs(np.round(rng.integers(1, 32767, 1 << 16)
                         / np.float32(32767.0)).astype(np.float32)
         ).view(np.uint32)).astype(np.uint64),
        np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                  0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001],
                 np.uint64),
    ]).astype(np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("name", ["ms", "uq", "qz"])
def test_rounding_points_match_f64_references(name):
    x = _rounding_sample()
    ref = {"ms": P.ms_reference, "uq": P.uq_reference,
           "qz": P.qz_reference}[name]
    with np.errstate(all="ignore"):
        want = ref(x.copy())
    got = R.PLAIN[name](torch.from_numpy(x.copy())).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | \
        (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{(~same).sum()} mismatches, first x=" \
        f"{x[~same][:3]!r}"


def test_uq_negative_zero_gives_positive_zero():
    """The reference's (float)(uint32_t)(int64_t)x gives +0.0 for -0.0
    and -0.5 (torch.remainder would keep -0.0)."""
    x = torch.tensor([-0.0, -0.5, 0.0, -1.0, -4294967296.0, 3.75])
    got = R.uq_f64(x)
    assert got.view(torch.int32).tolist()[:3] == [0, 0, 0]
    assert got.tolist()[3:] == [4294967296.0, 0.0, 3.0]
    assert torch.remainder(torch.tensor([-0.0]), 2.0 ** 32) \
        .view(torch.int32).item() == -2 ** 31


def test_sweep_plain_control_flow_on_cpu():
    """On the CPU the sweep step is the plain version, so a small chunk
    compares the plain functions with themselves; the chunk inputs are
    the consecutive bit patterns."""
    x = R.chunk_inputs(2 ** 32 - 4, 4, "cpu")
    assert x.view(torch.int32).tolist() == [-4, -3, -2, -1]
    res = R.sweep(chunk_bits=30, device="cpu", chunks=[])
    assert res["chunks_swept"] == 0 and res["mismatching_chunks"] == []
    out = R.rounding_sweep_all(2 ** 31, 1024, "cpu")[
        R.CONSTRUCTIONS.index("uq")]
    assert out.shape == (1024,) and int(R.mismatches(
        out, R.uq_f64(R.chunk_inputs(2 ** 31, 1024, "cpu")))) == 0
    with pytest.raises(ValueError):
        R.rounding_sweep_all(2 ** 32 - 2, 4, "cpu")


# (base, n): ragged chunk sizes (n % 4 != 0), chunks that end at 2^32
# (the last bit pattern 0xFFFFFFFF), and one across the sign bit
SWEEP_CHUNKS = {"ragged_1": (0, 1), "ragged_5": (12345, 5),
                "ragged_1027": (2 ** 31 - 700, 1027),
                "top_7": (2 ** 32 - 7, 7), "top_4096": (2 ** 32 - 4096, 4096)}


@pytest.mark.parametrize("chunk", list(SWEEP_CHUNKS))
def test_sweep_all_rows_are_the_plain_constructions_on_cpu(chunk):
    """rounding_sweep_all gives [3, n], row c bitwise equal to the plain
    function of construction c (CONSTRUCTIONS order) on the chunk's
    inputs, on ragged chunks and chunks that end at 2^32."""
    base, n = SWEEP_CHUNKS[chunk]
    got = R.rounding_sweep_all(base, n, "cpu")
    assert got.shape == (3, n)
    x = R.chunk_inputs(base, n, "cpu")
    for k, name in enumerate(R.CONSTRUCTIONS):
        assert int(R.mismatches(got[k], R.PLAIN[name](x))) == 0, name
    if base + n == 2 ** 32:
        assert R.chunk_inputs(base, n, "cpu").view(torch.int32)[-1] == -1


@pytest.mark.parametrize("n", [1, 3, 4, 5, 2 ** 24, 2 ** 32 - 1, 2 ** 32])
def test_sweep_row_stride_keeps_rows_aligned(n):
    """rounding_sweep_all's rows start a multiple of 16 bytes apart: the
    row stride is n rounded up to the kernel's 4-float vector."""
    ld = R.row_stride(n)
    assert ld % 4 == 0 and n <= ld < n + 4


def test_sweep_chunk_checks():
    """A chunk past 2^32, an empty one, or a device that is neither CPU
    nor CUDA raise ValueError; a sweep on no chunk reports all three
    constructions and nothing swept."""
    for base, n in ((2 ** 32 - 2, 4), (0, 0), (2 ** 32, 1), (-1, 2)):
        with pytest.raises(ValueError):
            R.rounding_sweep_all(base, n, "cpu")
    with pytest.raises(ValueError):
        R.rounding_sweep_all(0, 4, "meta")
    res = R.sweep(chunk_bits=30, device="cpu", chunks=[])
    assert res["constructions"] == list(R.CONSTRUCTIONS)
    assert res["chunks_swept"] == 0 and res["mismatching_inputs"] == 0


def test_exact_idle_slots_frozen():
    frames = _frames(1)
    B = len(frames)
    rng = np.random.default_rng(2)
    st = DecoderState(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
        for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))
    keep = {n: getattr(st, n).clone() for n in ("store", "v_blocks",
                                                "prev_lines")}
    batch = JM.frame_to_batches([fr[0] for fr in frames])[0]
    ops = list(wire_from_batch(batch))
    ops[4][[2, 5]] = 0
    for route in ROUTES.values():
        pt, st = route(*ops, st, exact=True)
        for s in (2, 5):
            assert not pt[s].any()
            for n, a in keep.items():
                assert torch.equal(getattr(st, n)[s].view(torch.int32),
                                   a[s].view(torch.int32)), n
        assert pt[0].any()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _states_equal(a, b):
    return all(torch.equal(getattr(a, n).view(torch.int32),
                           getattr(b, n).view(torch.int32))
               for n in ("store", "v_blocks", "prev_lines"))


@pytest.mark.cuda
def test_k2_matches_plain_version_on_cuda():
    """K2 (the fused exact kernel) vs its plain version on the same CUDA
    tensors, 3 frames with an idle slot: bitwise."""
    dev = _cuda()
    frames = _frames(3)
    B = len(frames)
    sk, sr = init_state(B, dev), init_state(B, dev)
    for t in range(3):
        for batch in JM.frame_to_batches([fr[t] for fr in frames]):
            ops = [x.to(dev) if isinstance(x, torch.Tensor) else x
                   for x in wire_from_batch(batch)]
            ops[4][3] = 0
            n0 = LA.LAUNCHES["fused_granule_exact"]
            pk, sk = FS.fused_granule_step(*ops, sk, exact=True)
            assert LA.LAUNCHES["fused_granule_exact"] == n0 + 1
            pr, sr = FS.fused_granule_step_ref(*ops, sr, exact=True)
            assert torch.equal(pk, pr)
            assert _states_equal(sk, sr)
            assert not pk[3].any()


@pytest.mark.cuda
def test_k6_chunks_match_plain_versions_on_cuda():
    """A few 2^24-input chunks of the three rounding points, one launch
    per chunk: the sweep kernel (the device functions K2 calls) vs the
    plain f64 functions, bitwise; chunk 0 holds the positive subnormals,
    128 the negative ones."""
    dev = _cuda()
    chunks = [0, 1, 127, 128, 129, 255]
    n0 = LA.LAUNCHES["rounding_sweep"]
    res = R.sweep(24, dev, chunks=chunks)
    assert LA.LAUNCHES["rounding_sweep"] == n0 + len(chunks)
    assert res["mismatching_chunks"] == [] and res["chunks_swept"] == 6, res


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", list(SWEEP_CHUNKS))
def test_k6_ragged_and_top_chunks_on_cuda(chunk):
    """K6 on ragged chunks (n % 4 != 0: the tail past the last 16-byte
    vector) and chunks that end at 2^32, the three constructions in one
    launch (rows a 16-byte multiple apart): bitwise equal to the plain
    f64 functions."""
    dev = _cuda()
    base, n = SWEEP_CHUNKS[chunk]
    x = R.chunk_inputs(base, n, dev)
    n0 = LA.LAUNCHES["rounding_sweep"]
    got = R.rounding_sweep_all(base, n, dev)
    assert LA.LAUNCHES["rounding_sweep"] == n0 + 1
    for k, name in enumerate(R.CONSTRUCTIONS):
        assert int(R.mismatches(got[k], R.PLAIN[name](x))) == 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", RAGGED_B)
def test_k2_ragged_batches_and_idle_seams_on_cuda(n, pattern):
    """K2 at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3 (grid read from
    the kernel library) with idle slots at the ring's seams, both granule
    parities: bitwise equal to the plain version."""
    _cuda()
    check_ragged_seams(n, pattern, exact=True)
