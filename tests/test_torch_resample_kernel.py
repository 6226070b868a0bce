"""The streaming resampler's block (pdmp3_tpu_torch/ops/resample.py
``resample_block``), whose CUDA kernel is K8 (csrc/resample.cu), and
``StreamResampler`` built on it.

On the CPU (the plain version, which the wrapper takes for CPU tensors):
the restructured ``StreamResampler`` bitwise equal to the route it
replaced (the carry and the block concatenated, two index vectors, the
gather and the multiply-adds, kept here as ``_old_call``) over steps of
1,152, 576 and 384 samples, a block shorter than taps - 1 and an empty
one, C = 1 and 2, int16 and f32 output; against the JAX package's
``StreamResampler`` within the tolerances of
``tests/test_torch_resample.py`` (f32 within FLOAT_TOL, int16 within 1
LSB: JAX's einsum sums in its own order), including a block shorter than
taps - 1 and state restored from a JAX resampler; the refusals; K8's
geometry (``k8_geometry``: one bulk-staged chunk for a serving block,
chunks whose windows fit K8_WINDOW for long blocks); a model of K8's
walk over window starts, which computes every output once with the
(m, p) of divmod over every running phase of five rate pairs; the CPU
path, which never loads the kernel library.

On the card (``cuda``-marked, skipped without one): K8 against the plain
version bitwise, int16 and f32 in and out, C = 1 and 2, N = 1152, 576,
384, 10 and 0, several steps carrying the phase, three rate pairs, at B
= 1, 2 and 2,053 (past the persistent grid), on blocks long enough to
take several chunks a stream, and on a strided view of a longer signal
(the resample sweep's blocks) and on blocks whose address and stream
stride are off 16-byte alignment; one launch a call; the refusals.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu.ops import resample as JR
from pdmp3_tpu_torch.ops import _build
from pdmp3_tpu_torch.ops import launch as LA
from pdmp3_tpu_torch.ops import resample as RS
from pdmp3_tpu_torch.ops.resample import StreamResampler

FLOAT_TOL = 0.02
# block sizes: Layer III, LSF, Layer I, shorter than taps - 1, empty
SIZES = (1152, 576, 384, 10, 0, 1152)
PAIRS = [(44100, 48000), (48000, 44100), (8000, 44100)]


def _old_call(rs, pcm):
    """The plain route StreamResampler.__call__ ran before K8, verbatim:
    the carry and the block concatenated, the window starts and phases
    uploaded, the gather and multiply-adds, the rounding."""
    x = torch.cat([rs.carry, pcm.to(torch.float32)], 1)
    n_in = int(pcm.shape[1])
    n_out = (n_in * rs.up - rs.phase + rs.down - 1) // rs.down
    ph = rs.phase + np.arange(n_out, dtype=np.int64) * rs.down
    m = torch.from_numpy(ph // rs.up).to(rs.device)
    p = torch.from_numpy(ph % rs.up).to(rs.device)
    y = RS._resample_block(x, m, p, rs.H, rs.taps)
    rs.phase = int(rs.phase + n_out * rs.down - n_in * rs.up)
    rs.carry = x[:, x.shape[1] - (rs.taps - 1):].contiguous()
    if rs.dtype == torch.int16:
        return torch.round(y).clamp(-32768, 32767).to(torch.int16)
    return y.to(rs.dtype)


def _blocks(seed, B, C, sizes=SIZES, int16=True):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.standard_normal((B, n, C)) * 9000
        out.append(np.clip(x, -32768, 32767).astype(np.int16) if int16
                   else x.astype(np.float32))
    return out


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32],
                         ids=["int16", "f32"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("from_rate,to_rate", PAIRS)
def test_restructured_resampler_equals_old_route(from_rate, to_rate, C,
                                                 dtype):
    """The restructured StreamResampler and the old route, fed the same
    int16 and f32 blocks: outputs, carries and phases bitwise equal
    every step."""
    for int16 in (True, False):
        new = StreamResampler(from_rate, to_rate, 3, C, dtype=dtype,
                              device="cpu")
        old = StreamResampler(from_rate, to_rate, 3, C, dtype=dtype,
                              device="cpu")
        for t, x in enumerate(_blocks(C + from_rate % 13, 3, C,
                                      int16=int16)):
            got = new(torch.from_numpy(x))
            want = _old_call(old, torch.from_numpy(x))
            assert got.dtype == want.dtype == dtype
            assert torch.equal(got.contiguous().view(torch.uint8),
                               want.contiguous().view(torch.uint8)), t
            assert torch.equal(new.carry, old.carry) and new.phase == \
                old.phase, t


@pytest.mark.parametrize("from_rate,to_rate", PAIRS)
def test_resampler_matches_jax_with_short_blocks(from_rate, to_rate):
    """Against JAX's StreamResampler on blocks of 1,152, 576, 384 and 10
    samples (shorter than taps - 1): the same n_out and phase, f32
    within FLOAT_TOL, int16 within 1 LSB."""
    sizes = (1152, 10, 576, 384, 1152)
    tf = StreamResampler(from_rate, to_rate, 2, 2, dtype=torch.float32,
                         device="cpu")
    jf = JR.StreamResampler(from_rate, to_rate, 2, 2, dtype=jnp.float32)
    ti = StreamResampler(from_rate, to_rate, 2, 2, device="cpu")
    ji = JR.StreamResampler(from_rate, to_rate, 2, 2)
    for x16 in _blocks(3, 2, 2, sizes):
        yt = tf(torch.from_numpy(x16.astype(np.float32))).numpy()
        yj = np.asarray(jf(jnp.asarray(x16.astype(np.float32))))
        assert yt.shape == yj.shape and tf.phase == jf.phase
        assert float(np.abs(yt - yj).max(initial=0)) <= FLOAT_TOL
        it = ti(torch.from_numpy(x16)).numpy()
        ij = np.asarray(ji(jnp.asarray(x16)))
        assert it.dtype == np.int16 and it.shape == ij.shape
        assert np.abs(it.astype(np.int32)
                      - ij.astype(np.int32)).max(initial=0) <= 1
        assert ti.phase == ji.phase
        np.testing.assert_allclose(tf.carry.numpy(), np.asarray(jf.carry))


def test_state_restored_from_jax_continues_it():
    """A port resampler built from a JAX resampler's carry and phase
    (after a block shorter than taps - 1) continues it within
    FLOAT_TOL."""
    jr = JR.StreamResampler(48000, 44100, 2, 2, dtype=jnp.float32)
    blocks = _blocks(4, 2, 2, (1152, 7, 576, 1152, 384), int16=False)
    for x in blocks[:2]:
        jr(jnp.asarray(x))
    tr = StreamResampler(48000, 44100, 2, 2, dtype=torch.float32,
                         device="cpu", carry=np.asarray(jr.carry),
                         phase=jr.phase)
    for x in blocks[2:]:
        yt = tr(torch.from_numpy(x)).numpy()
        yj = np.asarray(jr(jnp.asarray(x)))
        assert yt.shape == yj.shape and tr.phase == jr.phase
        assert float(np.abs(yt - yj).max()) <= FLOAT_TOL


def test_block_refusals():
    """A carry or filter bank that does not fit the block, or operands
    on other devices, raise."""
    rs = StreamResampler(44100, 48000, 2, 2, device="cpu")
    x = torch.zeros(2, 1152, 2, dtype=torch.int16)
    with pytest.raises(ValueError):
        RS.resample_block(rs.carry[:1], x, 0, rs.up, rs.down, rs.H, 10)
    with pytest.raises(ValueError):
        RS.resample_block(rs.carry, x, 0, rs.up + 1, rs.down, rs.H, 10)
    with pytest.raises(ValueError):
        RS.resample_block(rs.carry, x, 0, rs.up, rs.down, rs.H[:, :5], 10)
    with pytest.raises(ValueError):
        RS.resample_block(rs.carry.to(torch.float64), x, 0, rs.up, rs.down,
                          rs.H, 10)


@pytest.mark.parametrize("from_rate,to_rate", PAIRS + [(48000, 8000)])
def test_k8_geometry_covers_each_stream(from_rate, to_rate):
    """K8's chunks cover the window positions of a stream's outputs, each
    chunk's window fits K8_WINDOW samples a channel (or is the whole x,
    when that does) and the shared memory sized for it; a serving block
    (1,152 samples) is one chunk, bulk-staged when asked, and no block of
    10 or more than K8_WINDOW samples is."""
    rs = StreamResampler(from_rate, to_rate, 1, 2, device="cpu")
    up, down, taps = rs.up, rs.down, rs.taps
    K = taps - 1
    for n_in in (0, 10, 1152, 9216, 100000):
        for phase in (0, down - 1):
            n_out = (n_in * up - phase + down - 1) // down
            g = RS.k8_geometry(up, down, taps, 2, n_out, n_in, phase, 2,
                               True)
            span = g["p_end"] - g["p_first"]
            assert g["chunks"] * g["p_chunk"] >= span
            assert (g["chunks"] - 1) * g["p_chunk"] < max(span, 1)
            if n_out:
                assert g["p_first"] == phase // up
                assert g["p_end"] - 1 + K < K + n_in   # windows inside x
            if g["chunks"] == 1:
                assert g["win"] == K + n_in
            else:
                assert g["win"] == g["p_chunk"] + K <= RS.K8_WINDOW
                assert g["p_chunk"] % RS.k8_period(down) == 0
            assert g["bulk"] == (g["chunks"] == 1 and n_in > 0)
            stage = 2 * (-(-n_in * 4 // 16) * 16) if g["bulk"] else 0
            assert g["smem"] >= (4 * up * g["hstride"] + stage
                                 + 8 * g["win"])
            if n_in == 1152:
                assert g["chunks"] == 1 and g["bulk"]
            if n_in > RS.K8_WINDOW:
                assert g["chunks"] > 1 and not g["bulk"]


def _k8_walk(up, down, taps, n_in, phase):
    """A model of K8's enumeration of one stream's outputs
    (csrc/resample.cu resample_kernel): per chunk of k8_geometry, the
    class table (one divmod per class), the runs (c, k) with k fastest,
    K8_RUN positions a run and every output that starts there, stepped
    by adds and compares.  Returns the (j, m, p) of the outputs computed,
    in order, and checks each run's register window against the staged
    window."""
    n_out = (n_in * up - phase + down - 1) // down
    g = RS.k8_geometry(up, down, taps, 2, n_out, n_in, phase)
    K, R, L = taps - 1, RS.K8_RUN, RS.k8_period(down)
    classes, f, j_step = -(-L // R), up // down, L // down * up
    out = []
    for q in range(g["chunks"]):
        P0 = g["p_first"] + q * g["p_chunk"]
        P1 = min(P0 + g["p_chunk"], g["p_end"])
        W0, W1 = ((0, K + n_in) if g["chunks"] == 1
                  else (P0, min(P1 + K, K + n_in)))
        assert W1 - W0 <= g["win"]
        table = []
        for c in range(classes):
            m = P0 + c * R
            j = -((phase - m * up) // down)        # ceil((m up - phase) / down)
            table.append((j, phase + j * down - m * up))
        periods = -(-(P1 - P0) // L) if P1 > P0 else 0
        for t in range(classes * periods):
            c, k = divmod(t, periods)
            m0 = P0 + k * L + c * R
            j, phi = table[c][0] + k * j_step, table[c][1]
            assert 0 <= phi < down
            for i in range(R):
                pos_ok = c * R + i < L and m0 + i < P1
                cnt = f + (phi + f * down < up)
                for r in range(cnt):
                    if pos_ok and 0 <= j + r < n_out:
                        assert W0 <= m0 + i and m0 + i + K < W1
                        out.append((j + r, m0 + i, phi + r * down))
                j += cnt
                phi += cnt * down - up
    return out, n_out


@pytest.mark.parametrize("from_rate,to_rate", [
    (44100, 48000), (48000, 44100), (22050, 48000), (48000, 8000),
    (8000, 48000)])
def test_k8_walk_equals_divmod_over_every_phase(from_rate, to_rate):
    """The model of K8's stepped walk computes every output of a serving
    block exactly once, with (m, p) = divmod(phase + j down, up), for
    every running phase 0 .. down - 1; and so for two blocks split into
    chunks (9,216 samples)."""
    rs = StreamResampler(from_rate, to_rate, 1, 2, device="cpu")
    up, down, taps = rs.up, rs.down, rs.taps
    cases = [(1152, ph) for ph in range(down)] + [(9216, 0),
                                                  (9216, down - 1)]
    for n_in, phase in cases:
        got, n_out = _k8_walk(up, down, taps, n_in, phase)
        want = [(j, *divmod(phase + j * down, up)) for j in range(n_out)]
        assert sorted(got) == want, (n_in, phase)


def test_k8_instances_named_in_build_log():
    """_build.ptxas_summary names each of K8's instances by its type and
    value arguments, so the registers and spills of the sixteen stay
    apart."""
    from pdmp3_tpu_torch.ops._build import ptxas_summary
    mangled = {
        "resample_kernel<short,float,2,24>":
        "_ZN50_INTERNAL_0a1b2c3d_11_resample_cu_9f8e7d6c15resample_kernel"
        "IsfLi2ELi24EEEvPKfPKT_xS1_PfPT0_iiiiiiiiiiiiiii",
        "resample_kernel<float,short,1,0>":
        "_ZN50_INTERNAL_0a1b2c3d_11_resample_cu_9f8e7d6c15resample_kernel"
        "IfsLi1ELi0EEEvPKfPKT_xS1_PfPT0_iiiiiiiiiiiiiii"}
    log = "".join(
        f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {m}\n    0 bytes stack "
        f"frame, {k} bytes spill stores, 0 bytes spill loads\nptxas info"
        f"    : Used {60 + k} registers, used 1 barriers\n"
        for k, m in enumerate(mangled.values()))
    got = ptxas_summary(log)
    assert [g.split(":")[0] for g in got] == list(mangled)
    assert "Used 61 registers" in got[1]


def test_cpu_path_never_loads_the_library(monkeypatch):
    """CPU tensors run the plain version: the kernel library is never
    loaded (its loader raises here), and the counter does not move."""
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(_build, "load", refuse)
    n0 = LA.LAUNCHES["resample"]
    rs = StreamResampler(44100, 48000, 2, 2, device="cpu")
    for x in _blocks(5, 2, 2):
        rs(torch.from_numpy(x))
    assert LA.LAUNCHES["resample"] == n0


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 2053])
@pytest.mark.parametrize("from_rate,to_rate", PAIRS)
def test_k8_matches_plain_version_on_cuda(from_rate, to_rate, B):
    """K8 and the plain version on the same CUDA blocks, every pairing of
    int16 / f32 in and out, C = 1 and 2, blocks of 1,152, 576, 384, 10
    and 0 samples carrying the phase: outputs and carries bitwise, one
    launch a call."""
    dev = _cuda()
    for C in (1, 2):
        for int16 in (True, False):
            for dtype in (torch.int16, torch.float32):
                k = StreamResampler(from_rate, to_rate, B, C, dtype=dtype,
                                    device=dev)
                r = StreamResampler(from_rate, to_rate, B, C, dtype=dtype,
                                    device=dev)
                what = (C, int16, dtype)
                for t, x in enumerate(_blocks(B + C, B, C, int16=int16)):
                    x = torch.from_numpy(x).to(dev)
                    n0 = LA.LAUNCHES["resample"]
                    yk = k(x)
                    assert LA.LAUNCHES["resample"] == n0 + 1, what
                    n_in = x.shape[1]
                    n_out = (n_in * r.up - r.phase + r.down - 1) // r.down
                    yr, r.carry = RS.resample_block_ref(
                        r.carry, x, r.phase, r.up, r.down, r.H, n_out,
                        dtype)
                    r.phase += n_out * r.down - n_in * r.up
                    torch.cuda.synchronize()
                    assert _same(yk, yr), what + (t,)
                    assert _same(k.carry, r.carry), what + (t,)
                    assert k.phase == r.phase


@pytest.mark.cuda
def test_k8_reads_a_strided_block_on_cuda():
    """Blocks that are views of a longer [S, N, 1] signal (the resample
    sweep's): K8 reads them in place, bitwise equal to the plain
    version."""
    dev = _cuda()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (12, 1152 * 4, 1)).astype(np.float32)).to(dev)
    k = StreamResampler(22050, 48000, 12, 1, dtype=torch.float32,
                        device=dev)
    r = StreamResampler(22050, 48000, 12, 1, dtype=torch.float32,
                        device="cpu")
    for i in range(0, x.shape[1], 1152):
        blk = x[:, i:i + 1152]
        assert not blk.is_contiguous()
        assert torch.equal(k(blk).cpu(), r(blk.cpu()))
    assert torch.equal(k.carry.cpu(), r.carry)


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [True, False], ids=["int16", "f32"])
def test_k8_unaligned_stream_stride_on_cuda(int16):
    """Blocks of every size of SIZES cut from [B, N + 1, C] at sample 1
    (address and stream stride off 16-byte alignment: the kernel stages
    them by plain loads) and the same blocks copied contiguous (a
    serving block is bulk-staged), C = 1 and 2, B = 700, carrying the
    phase: both bitwise equal to the plain version."""
    dev = _cuda()
    for C in (1, 2):
        k = StreamResampler(44100, 48000, 700, C, device=dev)
        a = StreamResampler(44100, 48000, 700, C, device=dev)
        r = StreamResampler(44100, 48000, 700, C, device=dev)
        for t, x in enumerate(_blocks(40 + C, 700, C, int16=int16)):
            n = x.shape[1]
            wide = np.zeros((700, n + 1, C), x.dtype)
            wide[:, 1:] = x
            view = torch.from_numpy(wide).to(dev)[:, 1:]
            assert n == 0 or view.stride(0) * view.element_size() % 16
            dense = torch.from_numpy(x).to(dev)
            n_out = (n * r.up - r.phase + r.down - 1) // r.down
            yr, r.carry = RS.resample_block_ref(r.carry, dense, r.phase,
                                                r.up, r.down, r.H, n_out)
            r.phase += n_out * r.down - n * r.up
            yk, ya = k(view), a(dense)
            torch.cuda.synchronize()
            assert _same(yk, yr) and _same(ya, yr), (C, t, n)
            assert _same(k.carry, r.carry) and _same(a.carry, r.carry)


@pytest.mark.cuda
@pytest.mark.parametrize("from_rate,to_rate", [(44100, 48000),
                                               (48000, 8000)])
def test_k8_long_blocks_in_chunks_on_cuda(from_rate, to_rate):
    """Blocks of 9,216 samples, whose outputs K8 splits into several
    chunks a stream (k8_geometry), carrying the phase over three steps:
    bitwise equal to the plain version, C = 1 and 2."""
    dev = _cuda()
    for C in (1, 2):
        k = StreamResampler(from_rate, to_rate, 3, C, device=dev)
        r = StreamResampler(from_rate, to_rate, 3, C, device="cpu")
        for x in _blocks(C, 3, C, (9216, 9216, 577)):
            n_out = (x.shape[1] * k.up - k.phase + k.down - 1) // k.down
            assert x.shape[1] < 1000 or RS.k8_geometry(
                k.up, k.down, k.taps, C, n_out, x.shape[1],
                k.phase)["chunks"] > 1
            assert _same(k(torch.from_numpy(x).to(dev)).cpu(),
                         r(torch.from_numpy(x)))
            assert torch.equal(k.carry.cpu(), r.carry)


@pytest.mark.cuda
def test_k8_refusals_on_cuda():
    """Other dtypes, three channels and a block whose samples are not
    contiguous raise before any launch."""
    dev = _cuda()
    rs = StreamResampler(44100, 48000, 2, 2, device=dev)
    n0 = LA.LAUNCHES["resample"]
    with pytest.raises(ValueError):
        StreamResampler(44100, 48000, 2, 3, device=dev)(
            torch.zeros(2, 1152, 3, dtype=torch.int16, device=dev))
    with pytest.raises(ValueError):
        rs(torch.zeros(2, 1152, 2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        rs(torch.zeros(2, 2, 1152, dtype=torch.int16, device=dev)
           .transpose(1, 2))
    assert LA.LAUNCHES["resample"] == n0
