"""The port's stream-axis sharding (pdmp3_tpu_torch/parallel/sharding.py)
on 4 CPU shards: against the port's unsharded steps and the JAX package's
``decode_granules_sharded`` on its CPU mesh (tests/conftest.py).

Tolerance: exact mode bitwise (PCM, state and the clipped count) against
the unsharded port and JAX; fast mode bitwise against the unsharded port
step and within the fast contract (1 LSB on fewer than 1% of samples) of
the exact port step.
"""
import jax
import numpy as np
import pytest
import torch

from pdmp3_tpu.frontend import Frontend as JaxFrontend
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu.parallel import decode_granules_sharded as jax_sharded
from pdmp3_tpu.parallel import make_mesh as jax_make_mesh
from pdmp3_tpu.parallel import place_batch as jax_place_batch
from pdmp3_tpu.parallel import place_pallas_state as jax_place_pallas_state
from pdmp3_tpu.parallel import place_state as jax_place_state
from pdmp3_tpu_torch.frontend import Frontend
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.models import l12 as TL
from pdmp3_tpu_torch.ops.fused_step import fused_granule_step
from pdmp3_tpu_torch.parallel import (clipped_count,
                                      decode_granules_sharded, make_mesh,
                                      place, place_batch, place_state,
                                      sharded_frame_lsf_step,
                                      sharded_frame_step, sharded_l12_step)
from pdmp3_tpu_torch.testing import mp3gen
from test_torch_fused_step import assert_pcm_contract

B, SHARDS, FRAMES = 16, 4, 3
STATE = ("store", "v_blocks", "prev_lines")


def _parse(stream, n, frontend=Frontend, **kw):
    fe = frontend(**kw)
    fe.feed(stream)
    out = []
    for _ in range(n):
        res, fd = fe.read_frame()
        assert res == 0
        out.append(fd)
    return out


@pytest.fixture(scope="module")
def streams():
    """16 MPEG-1 streams (long, short, mixed, varied blocks; MS, MS +
    intensity and mono) of FRAMES + 2 frames."""
    return [mp3gen.make_stream(
        n_frames=FRAMES + 2, seed=100 + i,
        blocks=["long", "short", "mixed", "varied"][i % 4],
        mode=[0, 1, 3, 1][(i // 4) % 4],
        mode_extension=[0, 2, 0, 3][(i // 4) % 4]) for i in range(B)]


@pytest.fixture(scope="module")
def frames(streams):
    """Per stream, its first FRAMES frames as the port parses them."""
    return [_parse(s, FRAMES) for s in streams]


def _cat(shards):
    return torch.cat(list(shards))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _clipped(pcm) -> int:
    pcm = np.asarray(pcm)
    return int(((pcm == 32767) | (pcm == -32767)).sum())


def _sharded_and_whole(frames, exact):
    """Every granule of FRAMES frames through decode_granules_sharded over
    4 CPU shards and through the unsharded step; per granule (sharded
    PCM, state and clipped count, unsharded PCM and state)."""
    mesh = make_mesh(["cpu"] * SHARDS)
    shards = place_state(TM.init_state(B, "cpu"), mesh)
    whole = TM.init_state(B, "cpu")
    out = []
    for t in range(FRAMES):
        for batch in TM.frame_to_batches([f[t] for f in frames], "cpu"):
            pcms, shards, clipped = decode_granules_sharded(
                place_batch(batch, mesh), shards, mesh, exact=exact)
            pcm, whole = fused_granule_step(
                batch.ix, batch.scf_l, batch.scf_s, batch.meta,
                batch.active, batch.gr1, whole, exact=exact)
            out.append((pcms, [_copy(s) for s in shards], int(clipped),
                        pcm, _copy(whole)))
    return out


def _copy(state):
    # the steps update their state in place: keep this granule's
    return TM.DecoderState(*(getattr(state, k).clone() for k in STATE))


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_sharded_step_equals_unsharded_step(frames, exact):
    """Over 4 CPU shards, every granule's PCM, state and clipped count
    are bitwise the unsharded step's (the shards run the same plain
    version on contiguous slot ranges); fast PCM is within the fast
    contract of the exact step's."""
    steps = _sharded_and_whole(frames, exact)
    exact_steps = steps if exact else _sharded_and_whole(frames, True)
    for (pcms, shards, clipped, pcm, whole), ex in zip(steps, exact_steps):
        assert len(pcms) == SHARDS and pcms[0].shape == (B // SHARDS, 576,
                                                         2)
        assert torch.equal(_cat(pcms), pcm)
        for k in STATE:
            assert torch.equal(_bits(_cat(getattr(s, k) for s in shards)),
                               _bits(getattr(whole, k))), k
        assert clipped == _clipped(pcm)
        assert_pcm_contract(pcm.numpy(), ex[3].numpy())
    assert any(bool(s[3].any()) for s in steps)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_exact_sharded_step_equals_jax_sharded_step(streams, frames, kernel):
    """Exact mode: the port's sharded step over 4 CPU shards against the
    JAX package's decode_granules_sharded over 4 devices of its CPU mesh,
    on the same streams, on both JAX routes: the fused Pallas kernel
    under shard_map (interpret mode) bitwise in PCM, every state array
    and the clipped count; the XLA route under pjit bitwise in PCM,
    store, v_blocks and the clipped count.  Its prev_lines are not
    compared: the jitted, sharded XLA route latches them a few ulp away
    from its own unjitted chain (and from its Pallas route), a property
    of the JAX package; no step of these streams reads them into PCM."""
    steps = _sharded_and_whole(frames, True)
    jframes = [_parse(s, FRAMES, JaxFrontend) for s in streams]
    jmesh = jax_make_mesh(jax.devices()[:SHARDS])
    if kernel == "pallas":
        jstate = jax_place_pallas_state(PSF.init_pallas_state(B), jmesh)
        names = STATE
    else:
        jstate = jax_place_state(JM.init_state(B), jmesh)
        names = STATE[:2]
    k = 0
    for t in range(FRAMES):
        for jb in JM.frame_to_batches([f[t] for f in jframes]):
            pcm, jstate, clipped = jax_sharded(jax_place_batch(jb, jmesh),
                                               jstate, jmesh, exact=True,
                                               kernel=kernel)
            canon = (PSF.state_from_pallas(jstate) if kernel == "pallas"
                     else jstate)
            pcms, shards, port_clipped = steps[k][:3]
            np.testing.assert_array_equal(_cat(pcms).numpy(),
                                          np.asarray(pcm))
            for name in names:
                got = _bits(_cat(getattr(s, name) for s in shards)).numpy()
                want = np.asarray(getattr(canon, name)).view(np.int32)
                np.testing.assert_array_equal(got, want, err_msg=name)
            assert port_clipped == int(clipped)
            k += 1
    assert k == 2 * FRAMES


def test_state_is_split_into_shard_tensors():
    """place_state makes one state per shard, each a copy of its slot
    range on its device (not a view of the unsharded state): a sharded
    step leaves the unsharded state untouched."""
    mesh = make_mesh(["cpu"] * SHARDS)
    rng = np.random.default_rng(3)
    state = TM.DecoderState(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
        for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))
    shards = place_state(state, mesh)
    assert len(shards) == SHARDS
    for i, s in enumerate(shards):
        for k in STATE:
            t = getattr(s, k)
            assert t.shape[0] == B // SHARDS and t.is_contiguous()
            assert t.untyped_storage().data_ptr() != getattr(
                state, k).untyped_storage().data_ptr()
            lo = i * B // SHARDS
            assert torch.equal(t, getattr(state, k)[lo:lo + B // SHARDS])
    before = state.store.clone()
    for s in shards:
        s.store.add_(1)
    assert torch.equal(state.store, before)


def test_indivisible_batch_and_mismatched_shards_raise(frames):
    """B must be a multiple of the mesh size, as JAX asserts; the batch,
    state and mesh must have as many shards."""
    batch = TM.frame_to_batches([f[0] for f in frames], "cpu")[0]
    mesh3 = make_mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="do not split"):
        place_batch(batch, mesh3)
    with pytest.raises(ValueError, match="do not split"):
        place_state(TM.init_state(B, "cpu"), mesh3)
    mesh = make_mesh(["cpu"] * SHARDS)
    with pytest.raises(ValueError, match="shards for a mesh"):
        decode_granules_sharded(place_batch(batch, mesh),
                                place_state(TM.init_state(B, "cpu"),
                                            mesh)[:2], mesh)
    with pytest.raises(ValueError):
        make_mesh([])


def test_clipped_count_sums_every_shard():
    """The clipped-sample count over shards equals the count over the
    joined PCM, with both rails counted."""
    pcm = torch.zeros((8, 576, 2), dtype=torch.int16)
    pcm[1, 3, 0] = 32767
    pcm[6, 0, 1] = -32767
    pcm[6, 1, 1] = -32768
    got = clipped_count(list(pcm.split(2)), "cpu")
    assert got.dtype == torch.int64 and got.ndim == 0 and int(got) == 2


def test_sharded_frame_steps_equal_unsharded(frames):
    """The sharded frame steps on 4 CPU shards, each against its
    unsharded step bitwise: an MPEG-1 frame (two granules,
    decode_frame_soa), two MPEG-2 frames (decode_frame_lsf_soa) and a
    Layer II frame (decode_l12_frames), exact and fast."""
    mesh = make_mesh(["cpu"] * SHARDS)
    # MPEG-1: the frame's two granule batches as wire sections [2,B,...]
    grs = TM.frame_to_batches([f[0] for f in frames], "cpu")
    sec = [torch.stack([getattr(g, k) for g in grs])
           for k in ("ix", "scf_l", "scf_s", "meta")]
    act = grs[0].active
    lsf = [_parse(mp3gen.make_stream(n_frames=4, seed=30 + i, family=1,
                                     mode=1, mode_extension=3,
                                     stereo_extent_ch1=0.4,
                                     bitrate_index=11), 2, lsf=True)
           for i in range(B)]
    lb = [TM.frame_to_batches([f[t] for f in lsf], "cpu")[0]
          for t in range(2)]
    lops = [torch.stack([getattr(b, k) for b in lb])
            for k in ("ix", "scf_l", "scf_s", "meta", "is_pos", "active")]
    l2 = [_parse(mp3gen.make_l12_stream(layer=2, n_frames=3, seed=60 + i,
                                        bitrate_index=12), 1,
                 layers12=True)[0] for i in range(B)]
    l2ops = [torch.from_numpy(a) for a in TL.batch_from_frames(l2, 2)]
    for exact in (False, True):
        pcms, sts = sharded_frame_step(
            *[place(t, mesh, 1) for t in sec], place(act, mesh),
            place_state(TM.init_state(B, "cpu"), mesh), exact=exact)
        pcm, st = TM.decode_frame_soa(*sec, act, TM.init_state(B, "cpu"),
                                      exact=exact)
        assert pcm.shape == (B, 1152, 2) and torch.equal(_cat(pcms), pcm)
        assert torch.equal(_bits(_cat(s.v_blocks for s in sts)),
                           _bits(st.v_blocks))
        pcms, _ = sharded_frame_lsf_step(
            *[place(t, mesh, 1) for t in lops],
            place_state(TM.init_state(B, "cpu"), mesh), 1, exact=exact)
        pcm, _ = TM.decode_frame_lsf_soa(*lops, TM.init_state(B, "cpu"), 1,
                                         exact=exact)
        assert pcm.shape == (B, 2 * 576, 2) and torch.equal(_cat(pcms), pcm)
        pcms, sts = sharded_l12_step(
            *[place(t, mesh) for t in l2ops],
            place_state(TL.init_l12_state(B, "cpu"), mesh), exact=exact)
        pcm, st = TL.decode_l12_frames(*l2ops, TL.init_l12_state(B, "cpu"),
                                       exact=exact)
        assert pcm.shape == (B, 1152, 2) and torch.equal(_cat(pcms), pcm)
        assert torch.equal(_cat(s.v_blocks for s in sts), st.v_blocks)
        assert pcm.any()
