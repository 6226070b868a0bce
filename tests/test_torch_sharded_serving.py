"""The port's sharded serving pools (pdmp3_tpu_torch/runtime/sharded.py)
on 4 CPU shards: against the port's unsharded pools, the JAX package's
sharded pools on 4 devices of its CPU mesh (tests/conftest.py; the
fused Pallas kernel in interpret mode for Layer III) and the native
scalar decoder, on the same feed schedule; the pipelined drain
(``decode_step_pipelined``, ``drain_pending``) against the unsharded
pools' and the JAX sharded pools' inherited one; LoopFeeder and a
mid-stream join on a sharded pool; checkpoints across sharded, unsharded
and JAX pools.

Tolerance: exact mode bitwise (PCM every step, and the canonical
checkpoint: handle blobs and state); fast mode bitwise against the
port's unsharded pool and within the fast contract (1 LSB on fewer than
1% of samples) of the native decoder.
"""
import jax
import numpy as np
import pytest

from pdmp3_tpu.parallel import make_mesh as jax_make_mesh
from pdmp3_tpu.runtime import StreamDecoder as JaxStreamDecoder
from pdmp3_tpu.runtime.sharded import \
    ShardedL12StreamDecoder as JaxShardedL12
from pdmp3_tpu.runtime.sharded import ShardedStreamDecoder as JaxSharded
from pdmp3_tpu_torch import (L12StreamDecoder, LoopFeeder, StreamDecoder,
                             make_mesh)
from pdmp3_tpu_torch.host import (PROFILE_L12, PROFILE_LSF,
                                  native_decode_file)
from pdmp3_tpu_torch.runtime import (ShardedL12StreamDecoder,
                                     ShardedStreamDecoder)
from pdmp3_tpu_torch.testing import mp3gen
from test_torch_fused_step import assert_pcm_contract

B, SHARDS = 16, 4
MESH = make_mesh(["cpu"] * SHARDS)


def _layer3_streams(family: int, extra: int = 0) -> list[bytes]:
    """16 streams whose lengths grow by shard (3 + extra frames in shard
    0, 6 + extra in shard 3), so the first shards idle while the last
    still decode: the MPEG-1 mix of tests/test_sharded_serving.py
    (blocks, MS, intensity, mono), or LSF streams of `family` at its
    three rates."""
    out = []
    for i in range(B):
        n = 3 + extra + i // (B // SHARDS)
        if family:
            out.append(mp3gen.make_stream(
                n_frames=n + 1, seed=460 + i, family=family, sfreq=i % 3,
                bitrate_index=11, mode=1 if i % 2 else 0,
                mode_extension=3 if i % 2 else 0, stereo_extent_ch1=0.4))
        else:
            out.append(mp3gen.make_stream(
                n_frames=n, seed=400 + i,
                blocks=["long", "short", "varied", "mixed"][i % 4],
                mode=[0, 1, 1, 3][(i // 2) % 4],
                mode_extension=[0, 2, 3, 0][(i // 2) % 4]))
    return out


def _lockstep(decs, max_steps=40):
    """Parse and decode every pool in lockstep until none has an active
    slot; per pool the (PCM, active) of each step.  Every pool must count
    the same active slots."""
    out = [[] for _ in decs]
    for _ in range(max_steps):
        n = [d.parse_step() for d in decs]
        assert len(set(n)) == 1, n
        if n[0] == 0:
            return out
        for k, d in enumerate(decs):
            out[k].append((d.decode_step(), np.array(d.active)))
    raise AssertionError("the pools did not drain")


def _slot(steps, slot):
    return np.concatenate([p[slot] for p, a in steps if a[slot]])


def _assert_steps_equal(a, b):
    assert len(a) == len(b) > 0
    for k, ((pa, aa), (pb, ab)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(aa, ab, err_msg=f"step {k} active")
        np.testing.assert_array_equal(pa, pb, err_msg=f"step {k}")


def _assert_ckpt_equal(a, b):
    assert sorted(a) == sorted(b)
    assert [bytes(h) for h in a["handles"]] == [bytes(h) for h in
                                                 b["handles"]]
    for k in a:
        if k != "handles":
            np.testing.assert_array_equal(
                np.asarray(a[k]).view(np.int32),
                np.asarray(b[k]).view(np.int32), err_msg=k)


def _native(data, family=0, layer=3):
    profile = (PROFILE_LSF if family else 0) | (PROFILE_L12 if layer != 3
                                                else 0)
    return np.frombuffer(native_decode_file(data, profile=profile), "<i2")


def _check_vs_native(steps, streams, exact, family=0, layer=3, nch=None):
    for s, data in enumerate(streams):
        want = _native(data, family, layer)
        got = _slot(steps, s)
        a = got[:, 0] if nch is not None and nch[s] == 1 else got.reshape(-1)
        assert len(a) >= len(want) > 0
        if exact:
            np.testing.assert_array_equal(a[:len(want)], want)
        else:
            assert_pcm_contract(a[:len(want)], want)


@pytest.mark.parametrize("family", [0, 1], ids=["mpeg1", "mpeg2"])
def test_exact_sharded_pool_equals_unsharded_and_jax(family):
    """Exact MPEG-1 and MPEG-2 pools of 16 slots over 4 CPU shards, with
    shards idling at the end: every step bitwise equal to the port's
    unsharded pool and to the JAX package's sharded pool (Pallas kernel
    under shard_map); the final checkpoints equal (handle blobs and
    state); every slot bitwise against the native decoder."""
    streams = _layer3_streams(family)
    decs = [ShardedStreamDecoder(B, MESH, exact=True, parse_threads=1,
                                 family=family),
            StreamDecoder(B, exact=True, family=family, device="cpu"),
            JaxSharded(B, mesh=jax_make_mesh(jax.devices()[:SHARDS]),
                       exact=True, parse_threads=1, kernel="pallas",
                       family=family)]
    for s, data in enumerate(streams):
        for d in decs:
            assert d.feed(s, data) == 0
    sharded, whole, jax_sharded = _lockstep(decs)
    assert sharded[0][0].shape == (B, 576 if family else 1152, 2)
    _assert_steps_equal(sharded, whole)
    _assert_steps_equal(sharded, jax_sharded)
    assert not sharded[-1][1][:B // SHARDS].any()   # shard 0 idled
    for d in decs[1:]:
        _assert_ckpt_equal(decs[0].save_checkpoint(), d.save_checkpoint())
    nch = [decs[0].nch(s) for s in range(B)]
    assert nch == [decs[1].nch(s) for s in range(B)]
    _check_vs_native(sharded, streams, True, family, nch=nch)


def test_fast_sharded_pool_equals_unsharded_and_native():
    """Fast MPEG-1 over 4 CPU shards: every step bitwise equal to the
    port's unsharded fast pool (the same plain step on contiguous slot
    ranges), each slot within the fast contract of the native decoder."""
    streams = _layer3_streams(0)
    decs = [ShardedStreamDecoder(B, MESH, parse_threads=1),
            StreamDecoder(B, device="cpu")]
    for s, data in enumerate(streams):
        for d in decs:
            d.feed(s, data)
    sharded, whole = _lockstep(decs)
    _assert_steps_equal(sharded, whole)
    _check_vs_native(sharded, streams, False,
                     nch=[decs[0].nch(s) for s in range(B)])


@pytest.mark.parametrize("layer", [1, 2])
def test_sharded_l12_pool_equals_unsharded_and_jax(layer):
    """Layer I and II pools over 4 CPU shards, exact: every step bitwise
    equal to the port's unsharded pool and the JAX package's sharded
    pool, the final checkpoints equal, every slot bitwise against the
    native decoder (PROFILE_L12)."""
    streams = [mp3gen.make_l12_stream(layer=layer, n_frames=3 + i // 4,
                                      seed=500 + i, bitrate_index=12,
                                      mode=3 if i % 3 == 2 else 0)
               for i in range(B)]
    decs = [ShardedL12StreamDecoder(B, layer, MESH, exact=True),
            L12StreamDecoder(B, layer=layer, exact=True, device="cpu"),
            JaxShardedL12(B, layer=layer,
                          mesh=jax_make_mesh(jax.devices()[:SHARDS]),
                          exact=True)]
    for s, data in enumerate(streams):
        for d in decs:
            d.feed(s, data)
    sharded, whole, jax_sharded = _lockstep(decs)
    assert sharded[0][0].shape == (B, 12 * 32 if layer == 1 else 36 * 32,
                                   2)
    _assert_steps_equal(sharded, whole)
    _assert_steps_equal(sharded, jax_sharded)
    for d in decs[1:]:
        _assert_ckpt_equal(decs[0].save_checkpoint(), d.save_checkpoint())
    _check_vs_native(sharded, streams, True, layer=layer,
                     nch=[decs[0].nch(s) for s in range(B)])


def _pipelined(decs, max_steps=40):
    """Parse and decode_step_pipelined every pool in lockstep until none
    has an active slot, then drain_pending twice: per pool, what each
    call returned, the flush last.  Every pool must count the same active
    slots; the first call returns None, and so does the second drain."""
    out = [[] for _ in decs]
    for _ in range(max_steps):
        n = [d.parse_step() for d in decs]
        assert len(set(n)) == 1, n
        if n[0] == 0:
            break
        for k, d in enumerate(decs):
            out[k].append(d.decode_step_pipelined())
            # the JAX sharded Layer III pool decodes from zero-copy views
            # of a wire buffer that it does not swap: its step must end
            # before the next parse writes that buffer (else it reads
            # the next frame's wire on a loaded CPU)
            jax.block_until_ready(getattr(d, "_pending_pcm", None))
    else:
        raise AssertionError("the pools did not drain")
    for k, d in enumerate(decs):
        out[k].append(d.drain_pending())
        assert out[k][0] is None and d.drain_pending() is None
    return out


def _assert_pipelined_equal(a, b):
    assert len(a) == len(b) > 2
    for k, (pa, pb) in enumerate(zip(a[1:], b[1:])):
        np.testing.assert_array_equal(np.asarray(pa).view(np.int16),
                                      np.asarray(pb).view(np.int16),
                                      err_msg=f"call {k + 1}")


def _l12_streams(layer: int) -> list[bytes]:
    """16 Layer I/II streams whose lengths grow by shard (3 frames in
    shard 0, 6 in shard 3), stereo with every third mono."""
    return [mp3gen.make_l12_stream(layer=layer, n_frames=3 + i // 4,
                                   seed=500 + i, bitrate_index=12,
                                   mode=3 if i % 3 == 2 else 0)
            for i in range(B)]


def _pipelined_pools(route: str) -> tuple[list, list[bytes]]:
    """The sharded pool, the port's unsharded pool and, in exact mode,
    the JAX package's sharded pool of a route, and its streams."""
    jmesh = jax_make_mesh(jax.devices()[:SHARDS])
    if route.startswith("layer2"):
        fl = route == "layer2_float"
        return [ShardedL12StreamDecoder(B, 2, MESH, exact=True,
                                        float_pcm=fl),
                L12StreamDecoder(B, layer=2, exact=True, float_pcm=fl,
                                 device="cpu"),
                JaxShardedL12(B, layer=2, mesh=jmesh, exact=True,
                              float_pcm=fl)], _l12_streams(2)
    family = int(route.startswith("mpeg2"))
    exact = route.endswith("exact")
    decs = [ShardedStreamDecoder(B, MESH, exact=exact, parse_threads=1,
                                 family=family),
            StreamDecoder(B, exact=exact, family=family, device="cpu")]
    if exact:
        decs.append(JaxSharded(B, mesh=jmesh, exact=True, parse_threads=1,
                               kernel="pallas", family=family))
    return decs, _layer3_streams(family)


@pytest.mark.parametrize("route", ["mpeg1_fast", "mpeg1_exact",
                                   "mpeg2_exact", "layer2_exact",
                                   "layer2_float"])
def test_sharded_pipelined_drain_equals_unsharded_and_jax(route):
    """decode_step_pipelined / drain_pending of the sharded pools over 4
    CPU shards whose shards idle one after another: every call's PCM
    (the previous step's, None first) and the flush bitwise equal to the
    port's unsharded pool's pipelined drain and, in exact mode, to the
    JAX package's sharded pool's (inherited from its unsharded pool);
    the pipelined PCM is the synchronous decode_step's one step late,
    and the idle shard's slots are silent in the flush."""
    decs, streams = _pipelined_pools(route)
    for s, data in enumerate(streams):
        for d in decs:
            assert d.feed(s, data) == 0
    outs = _pipelined(decs)
    for other in outs[1:]:
        _assert_pipelined_equal(outs[0], other)
    sync, _ = _pipelined_pools(route)
    sync = sync[0]
    for s, data in enumerate(streams):
        sync.feed(s, data)
    _assert_pipelined_equal(outs[0], [None] + [p for p, _ in
                                               _lockstep([sync])[0]])
    assert not outs[0][-1][:B // SHARDS].any() and outs[0][-1].any()


def test_sharded_pipelined_idle_step_and_idle_shards():
    """Streams in shards 0 and 2 only: the pipelined call after a step
    returns that step's PCM with the idle shards' slots zero, bitwise the
    unsharded pool's; a step with no active slot returns the last PCM and
    leaves nothing pending (the next call and drain_pending return
    None); the pools' drain copies run per shard."""
    streams = _layer3_streams(0)
    decs = [ShardedStreamDecoder(B, MESH, exact=True, parse_threads=1),
            StreamDecoder(B, exact=True, device="cpu")]
    fed = [s for s in range(B) if (s // (B // SHARDS)) % 2 == 0]
    for s in fed:
        for d in decs:
            d.feed(s, streams[s])
    outs = [[], []]
    while True:
        n = [d.parse_step() for d in decs]
        assert n[0] == n[1]
        for k, d in enumerate(decs):
            outs[k].append(d.decode_step_pipelined())
        if n[0] == 0:
            break
    assert outs[0][0] is None and len(outs[0]) > 3
    _assert_pipelined_equal(outs[0], outs[1])
    q = B // SHARDS
    for p in outs[0][1:]:
        assert p.shape == (B, 1152, 2)
        assert not p[q:2 * q].any() and not p[3 * q:].any()
    for d in decs:
        assert d.decode_step_pipelined() is None
        assert d.drain_pending() is None


def test_idle_shards_decode_to_silence():
    """Streams in shards 0 and 2 only: the idle shards' pools do not
    step, their PCM is zeros, and the result is bitwise the unsharded
    pool's; with fetch=False one tensor per shard."""
    streams = _layer3_streams(0)
    decs = [ShardedStreamDecoder(B, MESH, exact=True, parse_threads=1),
            StreamDecoder(B, exact=True, device="cpu")]
    fed = [s for s in range(B) if (s // (B // SHARDS)) % 2 == 0]
    for s in fed:
        for d in decs:
            d.feed(s, streams[s])
    for d in decs:
        d.parse_step()
    shards = decs[0].decode_step(fetch=False)
    whole = decs[1].decode_step()
    assert [tuple(p.shape) for p in shards] == [(B // SHARDS, 1152, 2)] * 4
    assert not shards[1].any() and not shards[3].any() and shards[0].any()
    np.testing.assert_array_equal(
        np.concatenate([p.numpy() for p in shards]), whole)
    _assert_steps_equal(*_lockstep(decs))


def test_loop_feeder_and_join_on_sharded_pool():
    """LoopFeeder feeds a sharded pool through its global handle array,
    and a slot of the second shard joined mid-stream (released from the
    feeder first) serves the same window: every step bitwise equal to an
    unsharded pool driven alike, the join's window bitwise the native
    decoder's."""
    streams = _layer3_streams(0)[:6]
    joined = mp3gen.make_stream(n_frames=30, seed=80, blocks="varied",
                                mode=1, mode_extension=2, use_reservoir=True)
    slot, t0, dur = B // SHARDS + 2, 0.3, 0.15
    decs = [ShardedStreamDecoder(B, MESH, exact=True, parse_threads=1),
            StreamDecoder(B, exact=True, device="cpu")]
    feeders = [LoopFeeder(d, streams) for d in decs]
    for _ in range(2):
        assert [f.step() for f in feeders][0] > 0
        assert decs[0].parse_step() == decs[1].parse_step() == B
        np.testing.assert_array_equal(decs[0].decode_step(),
                                      decs[1].decode_step())
    joins = []
    for d, f in zip(decs, feeders):
        f.release(slot)
        joins.append(d.join(slot, joined, t0, dur))
    assert joins[0].drop_samples == joins[1].drop_samples
    got = []
    while not joins[0].exhausted or len(got) * 1152 < (
            joins[0].drop_samples + joins[0].take_samples):
        for f, j in zip(feeders, joins):
            f.step()
            j.pump()
        assert decs[0].parse_step() == decs[1].parse_step()
        pcm = decs[0].decode_step()
        np.testing.assert_array_equal(pcm, decs[1].decode_step())
        if decs[0].active[slot]:
            got.append(pcm[slot].tobytes())
        assert len(got) < 40
    j = joins[0]
    window = b"".join(got)[j.drop_samples * 4:
                           (j.drop_samples + j.take_samples) * 4]
    a = int(round(t0 * 44100)) * 4
    assert len(window) == j.take_samples * 4 > 0
    assert window == native_decode_file(joined)[a:a + len(window)]


def test_checkpoints_cross_sharded_unsharded_and_jax():
    """One exact stream schedule served by a chain of pools, each resumed
    from the previous one's checkpoint: sharded port pool -> unsharded
    port pool -> the JAX package's unsharded pool (Pallas kernel) ->
    sharded port pool.  Every step bitwise equal to one sharded pool
    serving the whole schedule, and the final checkpoints equal."""
    streams = _layer3_streams(0, extra=6)
    ref = ShardedStreamDecoder(B, MESH, exact=True, parse_threads=1)
    cur = ShardedStreamDecoder(B, MESH, exact=True, parse_threads=1)
    for s, data in enumerate(streams):
        ref.feed(s, data)
        cur.feed(s, data)
    chain = [lambda: StreamDecoder(B, exact=True, device="cpu"),
             lambda: JaxStreamDecoder(B, exact=True, kernel="pallas"),
             lambda: ShardedStreamDecoder(B, MESH, exact=True,
                                          parse_threads=1)]
    for make in chain + [None]:
        for _ in range(2):
            assert ref.parse_step() == cur.parse_step() > 0
            np.testing.assert_array_equal(ref.decode_step(),
                                          cur.decode_step())
        if make is not None:
            nxt = make()
            nxt.restore_checkpoint(cur.save_checkpoint())
            cur = nxt
    _assert_steps_equal(*_lockstep([ref, cur]))
    _assert_ckpt_equal(ref.save_checkpoint(), cur.save_checkpoint())


def test_sharded_pools_refuse_what_jax_refuses():
    """Slots that do not split over the mesh, more than one frame per
    step, and a checkpoint of another size: ValueError."""
    with pytest.raises(ValueError, match="do not split"):
        ShardedStreamDecoder(B + 2, MESH)
    with pytest.raises(ValueError, match="one frame per step"):
        ShardedStreamDecoder(B, MESH, frames_per_step=2)
    with pytest.raises(ValueError, match="do not split"):
        ShardedL12StreamDecoder(B - 1, 2, MESH)
    with pytest.raises(ValueError, match="one frame per step"):
        ShardedL12StreamDecoder(B, 2, MESH, frames_per_step=2)
    dec = ShardedStreamDecoder(B, MESH)
    with pytest.raises(ValueError, match="slots"):
        dec.restore_checkpoint(StreamDecoder(
            B // 2, device="cpu").save_checkpoint())
    with pytest.raises(IndexError):
        dec.feed(B, b"\xff")
