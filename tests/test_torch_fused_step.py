"""The port's fused granule step (pdmp3_tpu_torch/ops/fused_step.py)
against the JAX fused Pallas kernel, run as the JAX package's own tests
run it on the CPU: decode_granules_pallas(exact=False, block_lanes=8) in
interpret mode.

Tolerances:
- PCM: the fast contract, at most 1 LSB on fewer than 1% of samples
  (tests/test_pallas.py:71-76).  The port reads |x|^(4/3) from the
  correctly rounded table where JAX computes a Newton cube root (<= 2
  ulp apart), and its dots sum in another order than XLA's.
- store / v / prev_lines: |port - jax| <= STATE_RTOL * max(1, max|jax|).
  The only differences are f32 summation order and those ulps, which
  grow with the magnitude of the summed terms, not of each result;
  1e-5 of the largest value is ~80 ulp at that scale, while a wrong
  stage is off by O(value).
"""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu_torch.models.decoder import DecoderState, init_state
from pdmp3_tpu_torch.ops import dsp as D
from pdmp3_tpu_torch.ops import fused_step as FS
from pdmp3_tpu_torch.ops import launch as LA
from test_jax_decoder import _band12_zero_bits_stream
from test_pallas import _frames

MAX_LSB, MAX_FRAC = 1, 0.01
STATE_RTOL = 1e-5


def wire_from_batch(batch):
    """A JAX GranuleBatch as the port's wire-form operands: (ix, scf_l,
    scf_s, meta, active, gr1) with meta in PDMP3_META_* word order."""
    g = np.asarray
    B = g(batch.ix).shape[0]
    meta = np.zeros((B, D.META_WORDS), np.int32)
    for k, name in ((D.M_LAYOUT, "layout"), (D.M_BT, "block_type"),
                    (D.M_WSF, "win_switch"), (D.M_MIXED, "mixed"),
                    (D.M_GG, "global_gain"),
                    (D.M_SFS, "scalefac_scale"), (D.M_PRE, "preflag"),
                    (D.M_C1, "count1")):
        meta[:, k:k + 2] = g(getattr(batch, name))
    meta[:, D.M_SBG:D.M_SBG + 6] = g(batch.subblock_gain).reshape(B, 6)
    meta[:, D.M_MS] = g(batch.ms_flag)
    meta[:, D.M_IS] = g(batch.is_flag)
    meta[:, D.M_NCH] = g(batch.nch)
    gr1 = np.unique(g(batch.gr1))
    assert gr1.size == 1
    t = torch.from_numpy
    return (t(g(batch.ix).astype(np.int16)),
            t(g(batch.scf_l).astype(np.int16)),
            t(g(batch.scf_s).reshape(B, 2, 39).astype(np.int16)), t(meta),
            t(g(batch.active).astype(np.int32)), int(gr1[0]))


def assert_pcm_contract(got, want, what=""):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max() <= MAX_LSB, f"{what}: max {d.max()} LSB"
    assert (d != 0).mean() < MAX_FRAC, f"{what}: {(d != 0).mean():.4%}"


def assert_state_close(st, pst, what=""):
    """Port DecoderState vs JAX PallasState."""
    want = PSF.state_from_pallas(pst)
    for name in ("store", "v_blocks", "prev_lines"):
        a = getattr(st, name).numpy()
        b = np.asarray(getattr(want, name))
        tol = STATE_RTOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("bug_compat", [True, False])
def test_ref_matches_jax_pallas_over_6_granules(bug_compat):
    frames = _frames(3)
    B = len(frames)
    pst = PSF.init_pallas_state(B)
    st = init_state(B, "cpu")
    for t in range(3):
        for batch in JM.frame_to_batches([frames[b][t] for b in range(B)]):
            pj, pst = PSF.decode_granules_pallas(
                batch, pst, exact=False, bug_compat=bug_compat,
                block_lanes=8)
            pt, st = FS.fused_granule_step(*wire_from_batch(batch), st,
                                           bug_compat=bug_compat)
            assert pt.shape == (B, 576, 2) and pt.dtype == torch.int16
            assert_pcm_contract(pt.numpy(), pj, f"frame {t}")
            assert_state_close(st, pst, f"frame {t}")


def test_inactive_slots_frozen():
    """Mirror of test_pallas_inactive_slots_frozen: idle slots keep their
    state bitwise and emit silence; the others match JAX."""
    frames = _frames(1)
    B = len(frames)
    batch = JM.frame_to_batches([frames[b][0] for b in range(B)])[0]
    act = np.ones(B, np.int32)
    act[2] = 0
    act[5] = 0
    batch = batch._replace(active=jnp.asarray(act))
    rng = np.random.RandomState(0)
    store_t = rng.randn(2, 18, 32, B).astype(np.float32)
    v_t = rng.randn(2, 15, 64, B).astype(np.float32)
    prev = rng.randn(B, 3).astype(np.float32)
    pst0 = PSF.PallasState(store_t=jnp.asarray(store_t),
                           v_t=jnp.asarray(v_t), prev_lines=jnp.asarray(prev))
    pj, pst1 = PSF.decode_granules_pallas(batch, pst0, exact=False,
                                          block_lanes=8)
    st0 = DecoderState(
        store=torch.from_numpy(store_t.transpose(3, 0, 2, 1).copy()),
        v_blocks=torch.from_numpy(v_t.transpose(3, 0, 1, 2).copy()),
        prev_lines=torch.from_numpy(prev.copy()))
    keep = DecoderState(st0.store.clone(), st0.v_blocks.clone(),
                        st0.prev_lines.clone())
    pt, st1 = FS.fused_granule_step(*wire_from_batch(batch), st0)
    pt = pt.numpy()
    for s in (2, 5):
        assert (pt[s] == 0).all()
        for name in ("store", "v_blocks", "prev_lines"):
            assert torch.equal(getattr(st1, name)[s].view(torch.int32),
                               getattr(keep, name)[s].view(torch.int32))
    assert (pt[0] != 0).any()
    assert_pcm_contract(pt, pj)
    assert_state_close(st1, pst1)


def test_band12_zero_bits_prev_lines_bit_pattern():
    """The band-12 carry is read as float BITS (+0.0 gives gain 1, -0.0
    gain 0): on the directed fixture the port's prev_lines must have the
    same bit pattern as JAX's after every granule, and PCM the fast
    contract."""
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
            pj, pst = PSF.decode_granules_pallas(batch, pst, exact=False,
                                                 block_lanes=8)
            pt, st = FS.fused_granule_step(*wire_from_batch(batch), st)
            want = np.asarray(pst.prev_lines).view(np.uint32)
            got = st.prev_lines.numpy().view(np.uint32)
            np.testing.assert_array_equal(got, want)
            seen_zero |= bool((want == 0).all())
            assert_pcm_contract(pt.numpy(), pj)
    assert seen_zero   # the fixture reached the +0.0 carry


@pytest.mark.parametrize("bad", ["ix_dtype", "meta_shape", "gr1",
                                 "noncontig"])
def test_step_rejects_malformed_operands(bad):
    frames = _frames(1)
    batch = JM.frame_to_batches([frames[b][0] for b in range(2)])[0]
    ix, scf_l, scf_s, meta, act, gr1 = wire_from_batch(batch)
    st = init_state(2, "cpu")
    if bad == "ix_dtype":
        ix = ix.to(torch.int32)
    elif bad == "meta_shape":
        meta = meta[:, :24]
    elif bad == "gr1":
        gr1 = 2
    else:
        st.store = st.store.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        FS.fused_granule_step(ix, scf_l, scf_s, meta, act, gr1, st)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda():
    """The CUDA kernel vs its plain PyTorch version on the same CUDA
    tensors: bitwise by design (same rounding points, same summation
    order, no FMA contraction), so any difference fails; the fast
    contract and the state tolerance are checked as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _frames(3)
    B = len(frames)
    act = torch.ones(B, dtype=torch.int32)
    act[3] = 0
    sk, sr = init_state(B, "cuda"), init_state(B, "cuda")
    for t in range(3):
        for batch in JM.frame_to_batches([frames[b][t] for b in range(B)]):
            ops = [x.cuda() if isinstance(x, torch.Tensor) else x
                   for x in wire_from_batch(batch)]
            ops[4] = act.cuda()
            n0 = LA.LAUNCHES["fused_granule"]
            pk, sk = FS.fused_granule_step(*ops, sk)
            assert LA.LAUNCHES["fused_granule"] == n0 + 1
            pr, sr = FS.fused_granule_step_ref(*ops, sr)
            assert_pcm_contract(pk.cpu().numpy(), pr.cpu().numpy())
            assert torch.equal(pk, pr)
            for name in ("store", "v_blocks", "prev_lines"):
                a, b = getattr(sk, name), getattr(sr, name)
                tol = STATE_RTOL * max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= tol, name
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)), name
            assert not pk[3].any()


# ---- K1 / K2 as persistent kernels: the table image, the alignment the
# bulk copies need, ragged batches and idle slots at the ring's seams ----

def _image_sections():
    from pdmp3_tpu_torch.ops import consts as CC
    c = CC.host_consts(0)
    im = c["granule_smem"]
    bounds = (CC.SMEM_COS36, CC.SMEM_IWIN, CC.SMEM_C3P, CC.SMEM_W2P,
              CC.SMEM_NWIN_T, CC.SMEM_SYND, CC.SMEM_FLOATS)
    shapes = ((18, 36), (4, 36), (3, 18, 36), (3, 36), (32, 64), (16, 32))
    names = ("cos36", "imdct_win", "c3p", "win2p", "nwin_t", "synth_d")
    return c, {n: im[a:b].reshape(s) for n, a, b, s in
               zip(names, bounds, bounds[1:], shapes)}


@pytest.mark.parametrize("name", ["cos36", "imdct_win", "c3p", "win2p",
                                  "nwin_t", "synth_d"])
def test_granule_smem_image_reindexes_tables(name):
    """Each section of K1/K2's shared-memory table image equals its
    source table re-indexed: the short window w's basis and window moved
    to the output p they land on (c3p[w, m, p] = c3[m, 6w + p - 6],
    win2p[w, p] = win2[p - 6 - 6w], zero where w does not reach p),
    nwin transposed, the rest as they are."""
    c, sec = _image_sections()
    got = sec[name]
    assert got.dtype == np.float32
    if name == "c3p" or name == "win2p":
        want = np.zeros_like(got)
        for w in range(3):
            for p in range(6 + 6 * w, 18 + 6 * w):
                if name == "c3p":
                    want[w, :, p] = c["c3"][:, 6 * w + p - 6]
                else:
                    want[w, p] = c["win2"][p - 6 - 6 * w]
        # every nonzero coefficient of c3 appears once
        if name == "c3p":
            assert np.count_nonzero(got) == np.count_nonzero(c["c3"])
    elif name == "nwin_t":
        want = c["nwin"].T
    else:
        want = c[name]
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.ascontiguousarray(want).view(np.uint32))


@pytest.mark.parametrize("name", sorted(LA.BULK_ALIGN))
def test_bulk_alignment_check_raises_on_misaligned_operand(name):
    """The persistent kernels (K1-K3, K5) bulk-copy ix, meta, store,
    v_blocks and PCM (16-byte aligned) and copy scf_l, scf_s, prev_lines,
    active and the LSF is_pos sidecar by 4-byte words: an operand that
    starts off that alignment raises ValueError, aligned ones pass."""
    align = LA.BULK_ALIGN[name]
    base = torch.zeros(4096, dtype=torch.int16)
    assert base.data_ptr() % 64 == 0
    LA.check_bulk_alignment(**{name: base[align // 2:]})   # align bytes
    with pytest.raises(ValueError, match=name):         # align / 2 bytes
        LA.check_bulk_alignment(**{name: base[align // 4:]})


@pytest.mark.parametrize("stage", ["front", "antialias", "imdct", "matrix",
                                   "fir"])
def test_kernel_ab_ablation_empties_one_stage(stage):
    """kernel_ab.py --ablate finds each stage's opening comment once in
    the K1/K2 body and empties the block after it; the stages are
    disjoint, so skipping the others afterwards equals skipping all."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(root, "pdmp3_tpu_torch", "tools",
                                  "kernel_ab.py"))
    K = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(K)
    with open(os.path.join(root, "pdmp3_tpu_torch", "csrc",
                           "granule_persist.cuh")) as f:
        src = f.read()
    marker = K.STAGES[stage]
    assert src.count(marker) == 1
    out = K.skip_stages(src, [stage])
    after = out[out.index(marker):]
    assert after[after.index("{"):].startswith("{}")
    assert len(out) < len(src) and out.count("{") == out.count("}")
    rest = [s for s in K.STAGES if s != stage]
    assert K.skip_stages(out, rest) == K.skip_stages(src, list(K.STAGES))


# kernels of a -Xptxas -v report and a cuobjdump -sass listing: two
# template instances and one kernel without template arguments
_MANGLED = {
    "back_half_kernel<false,true>":
        "_ZN45_GLOBAL__N__a81dc2af_12_back_half_cu_5e83cad216back_half_"
        "kernelILb0ELb1EEEvPKfPKiS4_PfS5_S5_S5_PK6float4i",
    "fused_granule_kernel<true>":
        "_ZN49_GLOBAL__N__0c1d2e3f_16_fused_granule_cu_1a2b3c4d20fused_"
        "granule_kernelILb1EEEvPKsS2_S2_PKiS4_i",
    "rounding_sweep_kernel":
        "_ZN50_GLOBAL__N__9f8e7d6c_17_rounding_sweep_cu_4b3a291021rounding_"
        "sweep_kernelEjPfmjj"}


@pytest.mark.parametrize("which", ["ptxas", "sass"])
def test_kernel_names_from_build_log_and_sass(which):
    """_build.ptxas_summary and kernel_ab.sass_functions name a template
    instance with its arguments and a kernel without template arguments
    by its name, so that each kernel's lines stay its own (a kernel the
    parsers did not recognise used to add its lines to the kernel before
    it)."""
    names = list(_MANGLED)
    if which == "ptxas":
        from pdmp3_tpu_torch.ops._build import ptxas_summary
        log = "".join(
            f"ptxas info    : Compiling entry function '{_MANGLED[n]}' for "
            f"'sm_90a'\nptxas info    : Function properties for "
            f"{_MANGLED[n]}\n    0 bytes stack frame, {k} bytes spill "
            f"stores, 0 bytes spill loads\nptxas info    : Used {40 + k} "
            f"registers, used 1 barriers\n" for k, n in enumerate(names))
        got = ptxas_summary(log)
        assert [g.split(":")[0] for g in got] == names
        for k, g in enumerate(got):
            assert f"{k} bytes spill stores" in g
            assert f"Used {40 + k} registers" in g
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(root, "pdmp3_tpu_torch", "tools",
                                  "kernel_ab.py"))
    K = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(K)
    text = "".join(
        f"\t\tFunction : {_MANGLED[n]}\n"
        + "".join(f"        /*{16 * i:04x}*/   FADD R{k}, R{i}, R1 ;"
                  f"   /* 0x000fe20000000000 */\n" for i in range(k + 2))
        for k, n in enumerate(names))
    got = K.sass_functions(text)
    assert list(got) == ["back_half_kernelILb0ELb1EE",
                         "fused_granule_kernelILb1EE",
                         "rounding_sweep_kernel"]
    assert [len(v) for v in got.values()] == [2, 3, 4]
    assert got["rounding_sweep_kernel"][0] == "FADD R2, R0, R1"


RAGGED_B = ("1", "2", "grid-1", "grid+1", "2grid+3")
IDLE_SEAMS = ("none", "first", "last", "two_in_a_row", "alternating")


def ragged_batch(n: str, grid: int) -> int:
    return {"1": 1, "2": 2, "grid-1": grid - 1, "grid+1": grid + 1,
            "2grid+3": 2 * grid + 3}[n]


def idle_slots(pattern: str, B: int, grid: int) -> list[int]:
    """Slots made idle at the seams of the persistent blocks' two-stage
    ring (block j decodes slots j, j + grid, ...): the first slot, the
    last, two in a row of one block, or every other slot of each block
    (every other slot when B <= grid); "none" leaves every slot
    active."""
    if pattern == "none":
        return []
    if pattern == "first":
        return [0]
    if pattern == "last":
        return [B - 1]
    if pattern == "two_in_a_row":
        return [s for s in (1, 1 + grid) if s < B] or [0]
    step = grid if B > grid else 1
    return [b for b in range(B) if (b // step) % 2 == 1] or [0]


def tiled_operands(B: int, dev, seed: int = 0):
    """Both granules' wire operands of the 8 test streams' first frame,
    tiled over B slots, and a random starting state from numpy (seeded):
    ([(ix, scf_l, scf_s, meta, active, gr1)] * 2, DecoderState)."""
    frames = _frames(1)
    idx = torch.arange(B) % len(frames)
    grans = []
    for batch in JM.frame_to_batches([fr[0] for fr in frames]):
        ix, scf_l, scf_s, meta, act, gr1 = wire_from_batch(batch)
        grans.append([t[idx].contiguous().to(dev)
                      for t in (ix, scf_l, scf_s, meta, act)] + [gr1])
    rng = np.random.default_rng(seed)
    st = DecoderState(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
        for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))
    return grans, st


def check_ragged_seams(n: str, pattern: str, exact: bool) -> None:
    """K1 (K2 when exact) vs its plain version over granule 0 then 1 at
    the ragged B `n` with the idle `pattern`: PCM, store, v_blocks and
    prev_lines bitwise; idle slots silent and frozen; launches counted."""
    dev = torch.device("cuda")
    grid = LA.granule_launch_info(dev, exact)["grid"]
    B = ragged_batch(n, grid)
    grans, st0 = tiled_operands(B, dev)
    idle = idle_slots(pattern, B, grid)
    names = ("store", "v_blocks", "prev_lines")
    sk, sr = (DecoderState(*(getattr(st0, k).clone() for k in names))
              for _ in range(2))
    attr = "fused_granule_exact" if exact else "fused_granule"
    for ix, scf_l, scf_s, meta, act, gr1 in grans:
        act[idle] = 0
        n0 = LA.LAUNCHES[attr]
        pk, sk = FS.fused_granule_step(ix, scf_l, scf_s, meta, act, gr1, sk,
                                       exact=exact)
        assert LA.LAUNCHES[attr] == n0 + 1
        pr, sr = FS.fused_granule_step_ref(ix, scf_l, scf_s, meta, act, gr1,
                                           sr, exact=exact)
        assert torch.equal(pk, pr), (n, pattern, gr1)
        for name in names:
            a, b = getattr(sk, name), getattr(sr, name)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                (n, pattern, gr1, name)
        assert not pk[idle].any()
        assert len(idle) == B or pk.any()
    for name in names:
        assert torch.equal(getattr(sk, name)[idle].view(torch.int32),
                           getattr(st0, name)[idle].view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", RAGGED_B)
def test_k1_ragged_batches_and_idle_seams_on_cuda(n, pattern):
    """K1 at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3 (grid read from
    the kernel library) with idle slots at the ring's seams, both granule
    parities: bitwise equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_ragged_seams(n, pattern, exact=False)


# ---- several devices: shards of one card, and a second card ----

def _clone(st):
    return DecoderState(*(getattr(st, k).clone()
                          for k in ("store", "v_blocks", "prev_lines")))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_sharded_on_one_card_on_cuda(exact):
    """decode_granules_sharded over two shards of one card (K1, or K2
    when exact, once per shard) against the unsharded kernel step on the
    same card, over granule 0 then 1: PCM, state and the clipped count
    bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pdmp3_tpu_torch.models.decoder import GranuleBatch
    from pdmp3_tpu_torch.parallel import (decode_granules_sharded,
                                          make_mesh, place_batch,
                                          place_state)
    dev = torch.device("cuda", 0)
    mesh = make_mesh([dev, dev])
    grans, st = tiled_operands(2 * 37, dev)
    shards = place_state(_clone(st), mesh)
    attr = "fused_granule_exact" if exact else "fused_granule"
    for ix, scf_l, scf_s, meta, act, gr1 in grans:
        batch = GranuleBatch(ix, scf_l, scf_s, meta, act, gr1)
        n0 = LA.LAUNCHES[attr]
        pcms, shards, clipped = decode_granules_sharded(
            place_batch(batch, mesh), shards, mesh, exact=exact)
        assert LA.LAUNCHES[attr] == n0 + 2
        pk, st = FS.fused_granule_step(ix, scf_l, scf_s, meta, act, gr1, st,
                                       exact=exact)
        assert torch.equal(torch.cat(pcms), pk) and pk.any()
        for name in ("store", "v_blocks", "prev_lines"):
            got = torch.cat([getattr(s, name) for s in shards])
            assert torch.equal(got.view(torch.int32),
                               getattr(st, name).view(torch.int32)), name
        assert int(clipped) == int(((pk == 32767) | (pk == -32767)).sum())


@pytest.mark.cuda
def test_k1_on_a_device_that_is_not_current_on_cuda():
    """K1 on operands on cuda:1 while cuda:0 is the current device: the
    wrapper launches under the operands' device guard, so the step runs
    on cuda:1 and is bitwise its plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        grans, sk = tiled_operands(300, dev)
        sr = _clone(sk)
        for ops in grans:
            n0 = LA.LAUNCHES["fused_granule"]
            pk, sk = FS.fused_granule_step(*ops, sk)
            assert LA.LAUNCHES["fused_granule"] == n0 + 1 and pk.device == dev
            pr, sr = FS.fused_granule_step_ref(*ops, sr)
            assert torch.equal(pk, pr) and pk.any()
            for name in ("store", "v_blocks", "prev_lines"):
                assert torch.equal(getattr(sk, name).view(torch.int32),
                                   getattr(sr, name).view(torch.int32)), name
        assert torch.cuda.current_device() == 0
