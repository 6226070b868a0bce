"""The Layer I/II synthesis step (pdmp3_tpu_torch/ops/l12_synth.py), whose
CUDA kernel is K7 (csrc/l12_synth.cu), and the routes that reach it
through models.l12.decode_l12_frames.

On the CPU (the plain version, which the wrapper takes for CPU tensors):
against the JAX package's decode_l12_frames (pdmp3_tpu/models/l12.py, XLA)
on seeded subband samples and on frames of mp3gen.make_l12_stream, for
S = 12 and 36, S16 and float PCM, with mono and idle slots; two random
coded frames (``testing.l12wire``) requantized and carried through
decode_l12_wire at F = 2; a directed fixture whose sums
reach NaN, +-inf and beyond int32 (the quantize's out-of-range mask);
Layer I's new FIFO, 3 carried rows then the 12 new ones; the wrapper's
refusals and its CPU path, which never loads the kernel library.  K7's
arithmetic: the NWIN row map of its table image (consts.l12_smem_image)
against the table, bit for bit, and a PyTorch emulation of its
matrixing (the unique rows' dots, the mirrored rows copied, negated, or
recomputed where the dot is zero or NaN) bitwise equal to
dsp.subband_synthesis, FIFO included, in both summation orders, on rows
that are silent, cancel to +-0, hold +-0, subnormals and +-inf.

On the card (``cuda``-marked, skipped without one): the eight instances
against the plain version at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3
with idle slots at the seams of the slot ring, from a hostile state, with
subnormal subband samples and mono slots; on the emulation's silent,
cancelling and signed-zero rows (PCM and FIFO bits); a coded wire
requantized by K9 and decoded (nch a strided int16 view); the alignment
refusal; the launch counters
moving once a call; the launch geometry.

Tolerances: exact mode bitwise (PCM bits and v_blocks) against JAX;
fast mode within 1 LSB of JAX's S16 (its matrixing is an einsum, which
sums in its own order), float PCM within 1e-5 and the FIFO within 1e-5
of the largest magnitude.  The kernel against the plain version:
bitwise everywhere (same rounding points, same order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pdmp3_tpu.models import l12 as JL
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch.models import l12 as L
from pdmp3_tpu_torch.ops import _build
from pdmp3_tpu_torch.ops import consts as CC
from pdmp3_tpu_torch.ops import dsp as D
from pdmp3_tpu_torch.ops import l12_requant as RQ
from pdmp3_tpu_torch.ops import l12_synth as K7
from pdmp3_tpu_torch.ops import launch as LA
from pdmp3_tpu_torch.testing.l12wire import coded_wire
from test_torch_fused_step import (IDLE_SEAMS, RAGGED_B, idle_slots,
                                   ragged_batch)
from test_torch_l12 import _frames

LAYERS = {1: 12, 2: 36}
STATE_RTOL = 1e-5
FLOAT_TOL = 1e-5
# the sums a hostile FIFO row drives a slot to (NaN, +-inf, past int32)
HOSTILE = (np.nan, np.inf, -np.inf, 3e38, -3e38)


def _operands(S, B, seed, idle=(), mono=()):
    """Seeded sb f32 [B,2,S,32] (subband samples in [-1, 1]), nch,
    active (idle slots 0) and a random FIFO, as numpy."""
    rng = np.random.default_rng(seed)
    sb = rng.uniform(-1, 1, (B, 2, S, 32)).astype(np.float32)
    v = rng.standard_normal((B, 2, 15, 64)).astype(np.float32) * 0.1
    nch = np.full(B, 2, np.int32)
    nch[list(mono)] = 1
    act = np.ones(B, np.int32)
    act[list(idle)] = 0
    return sb, nch, act, v


def _port(sb, nch, act, v, exact, float_pcm, dev="cpu"):
    st = L.L12State(v_blocks=torch.from_numpy(v.copy()).to(dev))
    pcm, st = K7.l12_synth_step(*(torch.from_numpy(a).to(dev)
                                  for a in (sb, nch, act)), st, exact,
                                float_pcm)
    return pcm.cpu().numpy(), st.v_blocks.cpu().numpy()


def _jax(sb, nch, act, v, exact, float_pcm):
    pcm, st = JL.decode_l12_frames(sb, nch, act,
                                   JL.L12State(v_blocks=jnp.asarray(v)),
                                   exact=exact, float_pcm=float_pcm)
    return np.asarray(pcm), np.asarray(st.v_blocks)


def _assert_vs_jax(got, want, exact, float_pcm, what):
    (pt, vt), (pj, vj) = got, want
    assert pt.dtype == pj.dtype and pt.shape == pj.shape, what
    if exact:
        np.testing.assert_array_equal(pt.view(np.uint8), pj.view(np.uint8),
                                      what)
        np.testing.assert_array_equal(vt.view(np.uint32),
                                      vj.view(np.uint32), what)
        return
    d = np.abs(pt.astype(np.float64) - pj.astype(np.float64))
    assert d.max() <= (FLOAT_TOL if float_pcm else 1), what
    scale = max(float(np.abs(vj[np.isfinite(vj)]).max(initial=0)), 1.0)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=STATE_RTOL * scale,
                               err_msg=str(what))


@pytest.mark.parametrize("float_pcm", [False, True], ids=["s16", "float"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("layer", [1, 2])
def test_step_matches_jax_on_seeded_samples(layer, exact, float_pcm):
    """Three chained steps of 6 slots (slot 1 mono, slot 4 idle in the
    second step) against JAX decode_l12_frames: the FIFO carried by each
    side; idle slots silent with their FIFO frozen."""
    S, B = LAYERS[layer], 6
    vt = vj = None
    for t in range(3):
        sb, nch, act, v0 = _operands(S, B, 100 * layer + t, mono=(1,),
                                     idle=(4,) if t == 1 else ())
        if t == 0:
            vt = vj = v0
        pt, vt2 = _port(sb, nch, act, vt, exact, float_pcm)
        pj, vj2 = _jax(sb, nch, act, vj, exact, float_pcm)
        _assert_vs_jax((pt, vt2), (pj, vj2), exact, float_pcm,
                       (layer, exact, float_pcm, t))
        if t == 1:
            assert not pt[4].any()
            np.testing.assert_array_equal(vt2[4], vt[4])
        np.testing.assert_array_equal(pt[1, :, 0], pt[1, :, 1])  # mono
        vt, vj = vt2, vj2


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("layer", [1, 2])
def test_step_matches_jax_on_generated_frames(layer, exact):
    """decode_l12_frames over the frames of a stereo and a mono
    make_l12_stream stream and a starved slot, S16 and float PCM, each
    step against JAX's."""
    streams = [_frames(mp3gen.make_l12_stream(layer=layer, n_frames=3,
                                              seed=40 + layer,
                                              bitrate_index=12)),
               _frames(mp3gen.make_l12_stream(layer=layer, n_frames=3,
                                              seed=50 + layer, mode=3,
                                              bitrate_index=8))]
    for float_pcm in (False, True):
        vt = vj = np.zeros((3, 2, 15, 64), np.float32)
        for t in range(3):
            fds = [s[t] for s in streams] + [None]
            sb, nch, act = L.batch_from_frames(fds, layer)
            got = _port(sb, nch, act, vt, exact, float_pcm)
            want = _jax(sb, nch, act, vj, exact, float_pcm)
            _assert_vs_jax(got, want, exact, float_pcm,
                           (layer, exact, float_pcm, t))
            assert not got[0][2].any() and got[0][:2].any()
            vt, vj = got[1], want[1]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("layer", [1, 2])
def test_wire_two_frames_match_jax(layer, exact):
    """decode_l12_wire at F = 2 on a packed coded wire (random
    allocations, codes and scalefactor indices, ``testing.l12wire``; nch
    a strided int16 view of meta, active int16; slot 2 mono, slot 3 idle
    in the second frame) equals two JAX steps fed the samples that the
    plain requantization makes of it, PCM concatenated and the FIFO
    carried; float PCM too."""
    S, B, F = LAYERS[layer], 4, 2
    for float_pcm in (False, True):
        buf = coded_wire(B, layer, F, seed=7 + layer, mono=(2,),
                         idle=(B + 3,))
        w = L.l12_sections(buf, B, layer, F)
        sb = RQ.l12_requant_ref(w["body"], w["side"], w["geom"],
                                layer).numpy()
        assert sb.shape == (F, B, 2, S, 32) and sb[0, 0].any()
        v0 = _operands(S, B, layer)[3]
        pcm, st = L.decode_l12_wire(
            buf, L.L12State(v_blocks=torch.from_numpy(v0.copy())), B, layer,
            F, exact, float_pcm)
        vj, want = v0, []
        for f in range(F):
            nch = w["meta"][f, :, 0].numpy().astype(np.int32)
            act = w["active"][f].numpy().astype(np.int32)
            pj, vj = _jax(sb[f], nch, act, vj, exact, float_pcm)
            want.append(pj)
        _assert_vs_jax((pcm.numpy(), st.v_blocks.numpy()),
                       (np.concatenate(want, 1), vj), exact, float_pcm,
                       (layer, exact, float_pcm))


@pytest.mark.parametrize("float_pcm", [False, True], ids=["s16", "float"])
@pytest.mark.parametrize("layer", [1, 2])
def test_out_of_range_sums(layer, float_pcm):
    """FIFO rows of NaN, +-inf and +-3e38 in slots 0-4: the sums reach
    NaN, +-inf and beyond int32, which S16 turns into -32767 (the
    quantize's out-of-range mask, exact and fast) and float PCM into -1
    (NaN) or the rails; exact mode bitwise against JAX."""
    S, B = LAYERS[layer], 6
    sb, nch, act, v = _operands(S, B, 9)
    for s, x in enumerate(HOSTILE):
        v[s, s % 2, 5:9, 3:40] = x
    for exact in (True, False):
        pt, vt = _port(sb, nch, act, v, exact, float_pcm)
        if exact:
            _assert_vs_jax((pt, vt), _jax(sb, nch, act, v, True, float_pcm),
                           True, float_pcm, (layer, float_pcm))
        # slot s's hostile rows are in channel s % 2
        hit = [pt[s, :, s % 2] for s in range(len(HOSTILE))]
        if float_pcm:
            assert (hit[0] == -1).any()      # NaN
            assert (np.abs(np.concatenate(hit[1:])) == 1).any()
        else:
            assert all((h == -32767).any() for h in hit), exact
        assert np.isfinite(pt).all()


def test_layer1_fifo_carries_three_rows():
    """Layer I (S = 12 < 15): the new FIFO is the 3 newest carried rows
    followed by the 12 new rows, bitwise (both precisions); the idle
    slot keeps its FIFO."""
    sb, nch, act, v = _operands(12, 3, 5, idle=(2,))
    for exact in (True, False):
        _, vt = _port(sb, nch, act, v, exact, False)
        np.testing.assert_array_equal(vt[:2, :, :3], v[:2, :, 12:])
        np.testing.assert_array_equal(vt[2], v[2])
        _, vj = _jax(sb, nch, act, v, exact, False)
        np.testing.assert_array_equal(vt[:2, :, :3], vj[:2, :, :3])
        assert not np.array_equal(vt[:2, :, 3:], v[:2, :, 3:])


def test_cpu_path_never_loads_the_library(monkeypatch):
    """CPU tensors run the plain version: the kernel library is never
    loaded (its loader raises here), and no counter moves."""
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(_build, "load", refuse)
    k7 = ("l12_synth", "l12_synth_exact", "l12_synth_float",
          "l12_synth_float_exact")
    before = [LA.LAUNCHES[k] for k in k7]
    for float_pcm in (False, True):
        for layer in (1, 2):
            sb, nch, act, v = _operands(LAYERS[layer], 2, 1)
            pcm, _ = _port(sb, nch, act, v, True, float_pcm)
            assert pcm.shape == (2, LAYERS[layer] * 32, 2)
    assert before == [LA.LAUNCHES[k] for k in k7]


def test_refusals_and_instances():
    """S other than 12 / 36, a wrong FIFO shape, nch of another length
    and a non-contiguous sb raise; K7's instances are 13-20."""
    sb, nch, act, v = (torch.from_numpy(a) for a in _operands(12, 2, 3))
    st = L.L12State(v_blocks=v)
    with pytest.raises(ValueError):
        K7.l12_synth_step(torch.zeros(2, 2, 18, 32), nch, act, st)
    with pytest.raises(ValueError):
        K7.l12_synth_step(sb, nch, act, L.L12State(v_blocks=v[:, :, :14]))
    with pytest.raises(ValueError):
        K7.l12_synth_step(sb, nch[:1], act, st)
    with pytest.raises(ValueError):
        K7.l12_synth_step(sb.transpose(0, 1).contiguous().transpose(0, 1),
                          nch, act, st)
    got = {(layer, exact, f): LA.launch_instance(exact, float_pcm=f,
                                                 layer=layer)
           for layer in (1, 2) for f in (False, True)
           for exact in (False, True)}
    assert sorted(got.values()) == list(range(13, 21))
    assert got[(1, False, False)] == 13 and got[(2, True, True)] == 20
    with pytest.raises(ValueError):
        LA.launch_instance(family=1, layer=2)
    with pytest.raises(ValueError):
        LA.launch_instance(layer=4)


def _image():
    """K7's table image, split: ut [32, L12_COLS], synth_d [16, 32] and
    the store map decoded to (column, mirror, negated, the mirror's dot
    over a row of +0.0 is -0.0) per packed column."""
    im = CC.host_consts(0)["l12_smem"]
    cmap = im[CC.L12_MAP:CC.L12_FLOATS].view(np.int32)
    return (im[CC.L12_UT:CC.L12_SYND].reshape(32, CC.L12_COLS),
            im[CC.L12_SYND:CC.L12_MAP].reshape(16, 32),
            [(int(m) & 0xff, (int(m) >> 8) & 0xff, bool(m & CC.L12_NEG),
              bool(m & CC.L12_ZERO_NEG)) for m in cmap])


def test_k7_row_map_matches_the_table():
    """Every packed column of K7's image holds an NWIN row bit for bit,
    its mirror is that row's copy or negation bit for bit, the zero-row
    sign bit is set exactly when every coefficient of the mirror has its
    sign bit set, the columns and mirrors write each of the 64 FIFO
    columns once, 33 rows take a dot (31 mirror another), and synth_d is
    the table's."""
    c = CC.host_consts(0)
    nwin = c["nwin"].view(np.uint32)
    ut, synd, cmap = _image()
    written = []
    for q, (j, mir, neg, zneg) in enumerate(cmap):
        col = ut[:, q].view(np.uint32)
        if j >= CC.L12_NONE:
            assert mir >= CC.L12_NONE and not col.any(), q
            continue
        np.testing.assert_array_equal(col, nwin[j], err_msg=str(q))
        written.append(j)
        if mir < CC.L12_NONE:
            flip = np.uint32(0x80000000) if neg else np.uint32(0)
            np.testing.assert_array_equal(nwin[mir], nwin[j] ^ flip,
                                          err_msg=str(q))
            assert zneg == bool((nwin[mir] >> 31).all()), q
            written.append(mir)
    assert sorted(written) == list(range(64))
    assert sum(j < CC.L12_NONE for j, _, _, _ in cmap) == 33
    assert sum(m < CC.L12_NONE for _, m, _, _ in cmap) == 31
    np.testing.assert_array_equal(synd.view(np.uint32),
                                  c["synth_d"].view(np.uint32))
    assert [r for r, _ in CC.nwin_row_map(c["nwin"])].count(0) == 2


def _mirror_synthesis(x_time, v_blocks, exact, naive=False):
    """K7's matrixing emulated in PyTorch from its table image: the
    packed columns' dots (dsp's order), each mirrored column the copy,
    the negation, or, where a negated row's dot is zero or NaN: over a
    row of +0.0 samples the image's signed zero, else its own dot with
    the negated coefficients (naive: the negation always); then
    dsp.subband_synthesis's FIR.  Returns (sums, new_v, counts of
    negated, zero-row and recomputed values)."""
    ut, synd, cmap = (torch.from_numpy(np.ascontiguousarray(a))
                      if isinstance(a, np.ndarray) else a
                      for a in _image())
    dot = D._dot_seq if exact else D._dot_tree
    xs = x_time.transpose(-1, -2)                        # [B,2,S,32]
    u = dot(xs, ut)
    zero_row = (xs.contiguous().view(torch.int32) == 0).all(-1)
    nb = torch.full(xs.shape[:-1] + (64,), float("nan"))
    negated = zeroed = redone = 0
    for q, (j, mir, neg, zneg) in enumerate(cmap):
        if j < CC.L12_NONE:
            nb[..., j] = u[..., q]
        if mir >= CC.L12_NONE:
            continue
        if not neg:
            nb[..., mir] = u[..., q]
            continue
        d = u[..., q]
        redo = ((d == 0) | d.isnan()) & (not naive)
        zero = torch.full_like(d, -0.0 if zneg else 0.0)
        alt = torch.where(zero_row & (d == 0), zero,
                          dot(xs, -ut[:, q:q + 1])[..., 0])
        nb[..., mir] = torch.where(redo, alt, -d)
        negated += int((~redo).sum())
        zeroed += int((redo & zero_row & (d == 0)).sum())
        redone += int((redo & ~(zero_row & (d == 0))).sum())
    S = xs.shape[2]
    blocks = torch.cat([v_blocks, nb], 2)
    acc = torch.zeros_like(nb[..., :32])
    for j in range(16):
        half = 32 * (j & 1)
        acc = acc + synd[j] * blocks[:, :, 15 - j:15 + S - j,
                                     half:half + 32]
    return acc, blocks[:, :, S:], negated, zeroed, redone


def _mirror_fixture(S, seed):
    """sb f32 [6, 2, S, 32] and a FIFO: random rows, with slot 1 silent,
    slot 2's rows cancelling a unique NWIN row's dot to zero (two
    products that are exact negations, the rest +-0 products), slot 3
    holding -0.0 and +0.0 only in some rows and subnormals in others,
    slot 4 +-inf in one row of each channel."""
    sb, _, _, v = _operands(S, 6, seed)
    nwin = CC.host_consts(0)["nwin"]
    rng = np.random.default_rng(seed)
    sb[1] = 0.0
    sb[2] = 0.0
    for c in range(2):
        for s in range(S):
            r = (c * S + s) % 17                     # a unique row 0..16
            k1, k2 = rng.choice(32, 2, replace=False)
            sb[2, c, s, k1] = nwin[r, k2]
            sb[2, c, s, k2] = -nwin[r, k1]
            if s % 3 == 0:
                sb[2, c, s, (k1 + 1) % 32] = -0.0
    sb[3, :, ::2] = np.where(rng.random((2, (S + 1) // 2, 32)) < 0.5,
                             np.float32(-0.0), np.float32(0.0))
    sb[3, :, 1::2, :5] = np.float32(3e-41)
    sb[4, 0, 3, 7] = np.inf
    sb[4, 1, 5, 2] = -np.inf
    return sb, v


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("layer", [1, 2])
def test_k7_mirror_rule_equals_subband_synthesis(layer, exact):
    """The emulated mirror rule gives dsp.subband_synthesis's sums and
    new FIFO bit for bit on random, silent, cancelling, signed-zero,
    subnormal and infinite rows; each of the rule's branches is taken
    (negations, zero rows' signed zeros, recomputes of zero and NaN
    dots), and negating without the rule would differ."""
    S = LAYERS[layer]
    sb, v = _mirror_fixture(S, 60 + layer)
    x_time = torch.from_numpy(sb).transpose(-1, -2)
    vb = torch.from_numpy(v)
    want_s, want_v = D.subband_synthesis(x_time, vb, exact)
    got_s, got_v, negated, zeroed, redone = _mirror_synthesis(x_time, vb,
                                                              exact)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert negated > 0 and zeroed > 0 and redone > 0
    # the rule is needed: negating a silent row's +0 gives -0, and a
    # NaN's negation flips its sign bit
    _, naive_v, _, _, _ = _mirror_synthesis(x_time, vb, exact, naive=True)
    assert not torch.equal(naive_v.view(torch.int32),
                           want_v.view(torch.int32))


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counter(exact, float_pcm):
    return ("l12_synth" + ("_float" if float_pcm else "")
            + ("_exact" if exact else ""))


def _pair(sb, nch, act, v0, exact, float_pcm):
    """K7 and the plain version on the same CUDA operands from v0; the
    instance's counter checked."""
    name = _counter(exact, float_pcm)
    n0 = LA.LAUNCHES[name]
    sk = L.L12State(v_blocks=v0.clone())
    pk, sk = K7.l12_synth_step(sb, nch, act, sk, exact, float_pcm)
    assert LA.LAUNCHES[name] == n0 + 1
    sr = L.L12State(v_blocks=v0.clone())
    pr, sr = K7.l12_synth_step_ref(sb, nch, act, sr, exact, float_pcm)
    torch.cuda.synchronize()
    return pk, sk.v_blocks, pr, sr.v_blocks


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", RAGGED_B)
def test_k7_ragged_batches_and_idle_seams_on_cuda(n, pattern):
    """The eight instances at B = 1, 2, grid - 1, grid + 1, 2 grid + 3
    with idle slots at the seams of the slot ring, two chained steps from
    a hostile FIFO, every third slot mono, subnormal subband samples in
    slot 0: PCM bits and FIFO bitwise equal to the plain version, idle
    slots silent and frozen."""
    dev = _cuda()
    for layer, S in LAYERS.items():
        for exact in (False, True):
            for float_pcm in (False, True):
                grid = LA.granule_launch_info(dev, exact, layer=layer,
                                              float_pcm=float_pcm)["grid"]
                B = ragged_batch(n, grid)
                idle = idle_slots(pattern, B, grid)
                sb, nch, act, v = _operands(S, B, B + S, idle=idle,
                                            mono=range(0, B, 3))
                for s, x in enumerate(HOSTILE[:B]):
                    v[s, s % 2, 5:9, 3:40] = x
                sb[0, 0, :, :8] = np.float32(3e-39)   # subnormal
                sb, nch, act = (torch.from_numpy(a).to(dev)
                                for a in (sb, nch, act))
                v0 = torch.from_numpy(v).to(dev)
                what = (layer, exact, float_pcm, n, pattern)
                for t in range(2):
                    pk, vk, pr, vr = _pair(sb, nch, act, v0, exact,
                                           float_pcm)
                    assert torch.equal(_bits(pk), _bits(pr)), what + (t,)
                    assert torch.equal(_bits(vk), _bits(vr)), what + (t,)
                    assert not pk[idle].any(), what
                    assert torch.equal(_bits(vk[idle]), _bits(v0[idle]))
                    v0 = vr


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [1, 2])
def test_k7_silent_and_cancelling_rows_on_cuda(layer):
    """The eight instances on _mirror_fixture's slots (silent, cancelling
    a unique row's dot to zero, +-0 and subnormal samples, +-inf) beside
    random ones, slot 5 mono, two chained steps: PCM and FIFO bit for
    bit equal to the plain version, signed zeros and NaN bits
    included."""
    dev = _cuda()
    S = LAYERS[layer]
    sb, v = _mirror_fixture(S, 70 + layer)
    nch = np.full(6, 2, np.int32)
    nch[5] = 1
    sb, nch, act = (torch.from_numpy(a).to(dev)
                    for a in (sb, nch, np.ones(6, np.int32)))
    for exact in (False, True):
        for float_pcm in (False, True):
            v0 = torch.from_numpy(v).to(dev)
            for t in range(2):
                pk, vk, pr, vr = _pair(sb, nch, act, v0, exact, float_pcm)
                what = (layer, exact, float_pcm, t)
                assert torch.equal(_bits(pk), _bits(pr)), what
                assert torch.equal(_bits(vk), _bits(vr)), what
                v0 = vr


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [1, 2])
def test_k7_decodes_the_wire_in_place_on_cuda(layer):
    """decode_l12_wire at F = 2 on a device coded wire (random frames,
    ``testing.l12wire``; nch a strided int16 view, active int16): one K9
    launch a step and one K7 launch a frame, PCM and FIFO bitwise equal
    to the CPU's plain versions on the same wire."""
    dev = _cuda()
    S, B, F = LAYERS[layer], 300, 2
    buf = coded_wire(B, layer, F, seed=layer, mono=range(1, B, 5),
                     idle=[f * B + b for f in range(F)
                           for b in range(f, B, 7)])
    v = _operands(S, B, 0)[3]
    for exact in (False, True):
        n0 = LA.LAUNCHES[_counter(exact, False)]
        r0 = LA.LAUNCHES["l12_requant"]
        st = L.L12State(v_blocks=torch.from_numpy(v).to(dev))
        pcm, st = L.decode_l12_wire(buf.to(dev), st, B, layer, F, exact)
        assert LA.LAUNCHES[_counter(exact, False)] == n0 + F
        assert LA.LAUNCHES["l12_requant"] == r0 + 1
        ref = L.L12State(v_blocks=torch.from_numpy(v.copy()))
        want, ref = L.decode_l12_wire(buf, ref, B, layer, F, exact)
        assert torch.equal(pcm.cpu(), want)
        assert torch.equal(_bits(st.v_blocks.cpu()), _bits(ref.v_blocks))


@pytest.mark.cuda
def test_k7_refuses_misaligned_operands_on_cuda():
    """sb, v_blocks off 16-byte alignment raise before any launch; the
    counters do not move."""
    dev = _cuda()
    sb, nch, act, v = (torch.from_numpy(a).to(dev)
                       for a in _operands(36, 2, 4))
    flat = torch.zeros(sb.numel() + 1, device=dev)
    bad_sb = flat[1:].view(sb.shape)
    vflat = torch.zeros(v.numel() + 1, device=dev)
    bad_v = L.L12State(v_blocks=vflat[1:].view(v.shape))
    n0 = LA.LAUNCHES["l12_synth"]
    with pytest.raises(ValueError):
        K7.l12_synth_step(bad_sb, nch, act, L.L12State(v_blocks=v.clone()),
                          exact=False)
    with pytest.raises(ValueError):
        K7.l12_synth_step(sb, nch, act, bad_v, exact=False)
    with pytest.raises(ValueError):
        K7.l12_synth_step(sb, nch.to(torch.int64), act,
                          L.L12State(v_blocks=v.clone()), exact=False)
    assert LA.LAUNCHES["l12_synth"] == n0


@pytest.mark.cuda
def test_k7_launch_geometry_on_cuda():
    """Instances 13-20: 128 / 384 threads' worth of registers without
    spills (Layer I five blocks per SM, Layer II two), shared memory as the layout gives it (K7's 6,800 B table
    image, the ring, the new FIFO rows, the PCM row), a persistent
    grid."""
    dev = _cuda()
    smem = {(1, False): 36032, (1, True): 37568, (2, False): 63680,
            (2, True): 68288}
    for layer in (1, 2):
        for float_pcm in (False, True):
            for exact in (False, True):
                info = LA.granule_launch_info(dev, exact, layer=layer,
                                              float_pcm=float_pcm)
                assert info["dynamic_smem_bytes"] == smem[(layer,
                                                           float_pcm)]
                assert info["local_bytes"] == 0
                # Layer II's tiles budget 85 registers (two blocks)
                assert info["blocks_per_sm"] >= (2 if layer == 2 else 5)
                assert info["grid"] == (info["sm_count"]
                                        * info["blocks_per_sm"])
