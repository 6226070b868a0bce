"""Throughput benchmark of the port: the aggregate realtime factor of
batched MP3 decode on one NVIDIA GPU, and its correctness attestations.

    python -m pdmp3_tpu_torch.bench [B] [steps] [--device cuda|cpu]

Counterpart of the root ``bench.py`` (the JAX package's bench), function
by function, over the port alone.  It measures B concurrent granule
slots per step on every precision and route the port ships:

  * ``kernel``: the fused granule step (``ops.fused_step``), K1 fast
    and K2 exact (bit-exact with the reference decoder), K3 for LSF;
  * ``split``: ``models.decoder.decode_granules``, the stage ops and the
    back-half kernel K4 (instance 6 fast, 7 exact).

One granule is 576 samples, 13.06 ms of 44.1 kHz audio:

    RTF = (granules_decoded * 576 / 44100) / elapsed_seconds

(22,050 Hz for the LSF family-1 rates, 1152 samples per frame for Layer
II).  The headline is the faster route's device-resident rate: four
granule batches tiled to B slots on the card, rotated, the recurrent
state threaded, launched back to back with one synchronize per window
of max(1, steps // group) x group steps (``group``: min(K, steps), K
the steps of one dispatch in bench.py), after one untimed group.  No
CUDA graph: every step pays its launch, as the JAX loop pays its
dispatch.  Each timed configuration runs several windows (trials); its
key holds their median.

Attested in the same run, on the device: the kernel route against the
split route on four granules at 1,024 slots (exact: PCM and state
bitwise; fast: the largest PCM difference in LSB), and exact decode
(``TorchDSP(exact=True)``, the split route) byte-equal to the native
decoder (``host.native_decode_file``, bit-exact scalar C++) and, where
it builds, to the reference binary (``testing.golden``).

The end-to-end keys run the serving pools (``StreamDecoder``,
``SparseStreamDecoder``: native parse at one thread, wire upload, the
kernel): they are bound by the host's parse, not by the card.

The JSON line keeps bench.py's keys (``bench.py`` ``main``), units and
bases (``step_ms`` is one granule step at ``batch_slots``), with these
changes only:

- renamed: ``pallas`` -> ``kernel``, ``xla`` -> ``split``, ``_on_tpu``
  -> ``_on_gpu``, ``tunnel_h2d_gbps`` -> ``h2d_gbps`` (pinned host
  memory, as the pools upload from), and in ``serving_at_size``
  ``device_step_ms_tunnel`` -> ``replay_step_ms`` (a replayed step on
  the host clock, the host copy of its recorded wire included);
- dropped: ``e2e_serving_rtf_this_harness`` and
  ``e2e_serving_rtf_sparse_wire`` (the XLA pools: the port's pools
  always launch the kernel, so dense and sparse are its two e2e
  configurations) and ``projected_pcie_e2e_rtf`` (the card sits on PCIe:
  the e2e rate is measured);
- added: ``device`` (the card's name and power limit as nvidia-smi
  prints them), ``reference_status``, ``exact_bitexact_vs_native_on_gpu``,
  ``parse_threads`` (of the e2e pools), ``ranges`` (each timed key's
  [min, max] over its trials), ``launches`` (each kernel's launches, by
  measurement and in total: the bench checks every measurement's count
  against the steps it ran and raises on a difference), and in
  ``serving_at_size`` ``host_copy_ms_per_step`` and ``device_step_ms``
  (a replayed step split into the host copy of its recorded wire and
  the upload plus the two K1 launches, timed with CUDA events) and
  ``replay_matches_live`` (the replayed steps' PCM bitwise equal to the
  same steps decoded live);
- medians where bench.py kept the best; ``reference_binary_frames_per_sec``
  is null, not 0.0, where the reference binary does not build.

It runs on the card; ``--device cpu`` (for the tests) runs every route's
plain PyTorch version, and its numbers are host numbers whatever the
keys say (``device`` is then "cpu").  Without a card the default raises:
nothing moves to the CPU by itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import device as _guards  # noqa: F401  (TF32 off, no FTZ)
from .tools import (card, feasible_streams, launched_since, launches,
                    resolve_device)
from .tools.scale_sim import tiled_batch as tile_batch

# bytes of one decoded stereo MPEG-1 frame: 1152 samples x 2 x S16
FRAME_BYTES = 1152 * 2 * 2
# granule steps of one dispatch in bench.py (its K)
K = 64
# parsed wires the at-size measurement records and replays
RECORDED = 5
# bench.py _attest_exact_vs_reference's two streams (make_stream kwargs)
ATTEST_STREAMS = (
    dict(n_frames=6, blocks="varied", seed=7, mode=1, mode_extension=2,
         use_reservoir=True),
    dict(n_frames=6, blocks="mixed", seed=9, sfreq=2))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size, count and duration of a bench run; the defaults are
    bench.py's (its ``repeats`` 2 -> 5, and each host rate split into
    trials of ``host_seconds``, for the ranges)."""
    sweep: tuple = (4096, 8192)      # batch sizes of the kernel sweep
    steps: int = 128                 # granule steps a window (rounded)
    repeats: int = 5                 # timed windows a configuration
    e2e_slots: int = 4096
    e2e_distinct: int = 128
    e2e_trials: int = 3
    e2e_seconds: float = 3.0
    drain_slots: int = 2048
    drain_trials: int = 9
    drain_seconds: float = 5.0
    at_size_slots: int | None = None   # None: the best batch size
    at_size_steps: int = 24
    host_trials: int = 3
    host_seconds: float = 1.0
    lsf_e2e_slots: int = 1024
    lsf_distinct: int = 32

    @property
    def group(self) -> int:
        """Steps of one dispatch group: K, or all of `steps` below K."""
        return min(K, self.steps)

    @property
    def short_steps(self) -> int:
        """Steps of the LSF and Layer II windows (bench.py's max(32,
        steps // 4))."""
        return max(32, self.steps // 4)


def timed_steps(sz: Sizes, steps: int) -> int:
    """Granule steps in one timed window: whole groups, at least one."""
    return max(1, steps // sz.group) * sz.group


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spread(xs) -> tuple[float, list]:
    """(median, [min, max]) of a trial list."""
    xs = [float(x) for x in xs]
    return statistics.median(xs), [min(xs), max(xs)]


# ---- corpora: the streams of bench.py, for the same seeds ----

def corpus(spec, n: int, workers: int | None = None) -> list[bytes]:
    """The streams of the first n feasible configs spec(0), spec(1), ...
    (bench.py's ``while len(streams) < n`` loops; ``feasible_streams``
    makes them, in parallel from its SPAWN_FROM streams)."""
    return feasible_streams(map(spec, itertools.count()), n, workers)


def e2e_spec(i: int) -> dict:
    """bench.py ``_e2e_corpus``'s i-th stream: 40 frames, every rate."""
    return dict(n_frames=40, seed=300 + i,
                blocks=["long", "varied", "short", "mixed"][i % 4],
                mode=[0, 1, 1, 3][i % 4],
                mode_extension=(2 if i % 2 else 0) | (1 if i % 8 >= 6
                                                      else 0),
                bitrate_index=[9, 11, 14, 7][(i // 4) % 4],
                sfreq=i % 3, use_reservoir=i % 5 == 0)


def at_size_spec(i: int) -> dict:
    """bench.py ``_bench_serving_at_size``'s i-th stream: 12 frames."""
    return dict(n_frames=12, seed=7000 + i,
                blocks=["long", "varied", "short", "mixed"][i % 4],
                mode=[0, 1, 1, 3][i % 4],
                bitrate_index=[9, 11, 14, 7][(i // 4) % 4],
                sfreq=i % 3, use_reservoir=i % 5 == 0)


def lsf_spec(i: int) -> dict:
    """bench.py ``_bench_e2e_lsf``'s i-th MPEG-2 stream: 30 frames."""
    return dict(n_frames=30, seed=700 + i, family=1, sfreq=i % 3,
                bitrate_index=[9, 11, 14][(i // 3) % 3],
                mode=[0, 1, 1, 3][i % 4],
                mode_extension=3 if i % 2 else 0, stereo_extent_ch1=0.5,
                blocks=["long", "varied", "short", "mixed"][i % 4])


def build_pool(dev, n_streams: int = 4, frames_per_stream: int = 3
               ) -> list:
    """bench.py's mixed-coverage pool: each parsed frame of 4 generated
    streams (seeds 50-53) as B = 1 granule batches on dev."""
    from .frontend import Frontend
    from .models import decoder as M
    from .testing import mp3gen

    fds = []
    for i in range(n_streams):
        s = mp3gen.make_stream(n_frames=frames_per_stream + 2, seed=50 + i,
                               blocks=["long", "varied", "short",
                                       "mixed"][i % 4],
                               mode=1 if i % 2 else 0,
                               mode_extension=2 if i % 2 else 0)
        fe = Frontend()
        fe.feed(s)
        for _ in range(frames_per_stream):
            res, fd = fe.read_frame()
            if res != 0:
                break
            fds.append(fd)
    return [b for fd in fds for b in M.frame_to_batches([fd], dev)]


def lsf_pool(dev) -> list:
    """bench.py ``_measure_lsf``'s pool: the first 4 frames of one
    MPEG-2 stream (seed 60, intensity stereo), one batch each."""
    from .frontend import Frontend
    from .models import decoder as M
    from .testing import mp3gen

    fe = Frontend(lsf=True)
    fe.feed(mp3gen.make_stream(n_frames=6, seed=60, family=1, mode=1,
                               mode_extension=3, stereo_extent_ch1=0.4,
                               blocks="varied", bitrate_index=11))
    batches = []
    for _ in range(4):
        res, fd = fe.read_frame()
        if res != 0:
            break
        batches.extend(M.frame_to_batches([fd], dev))
    return batches


def l12_frames() -> list:
    """bench.py ``_measure_l12``'s frames: the first 4 of one Layer II
    stream (seed 61)."""
    from .frontend import Frontend
    from .testing import mp3gen

    fe = Frontend(layers12=True)
    fe.feed(mp3gen.make_l12_stream(layer=2, n_frames=6, seed=61,
                                   bitrate_index=12))
    frames = []
    for _ in range(4):
        res, fd = fe.read_frame()
        if res != 0:
            break
        frames.append(fd)
    return frames


# ---- device-resident rates ----

def step_fn(path: str, exact: bool):
    """(batch, state) -> (pcm, state): one granule step of the batch's
    family on `path`, "kernel" (fused_granule_step: K1 / K2 / K3) or
    "split" (decode_granules: stage ops + K4); state updated in place."""
    from .models import decoder as M
    from .ops.fused_step import fused_granule_step

    if path == "kernel":
        return lambda b, s: fused_granule_step(
            b.ix, b.scf_l, b.scf_s, b.meta, b.active, b.gr1, s, True,
            exact, b.family, b.is_pos)
    if path == "split":
        return lambda b, s: M.decode_granules(b, s, exact)
    raise ValueError(f"path must be 'kernel' or 'split', got {path!r}")


def windows(one, batches, state, B: int, samples: int, rate: float,
            steps: int, sz: Sizes, dev) -> dict:
    """Time `one` ((batch, state) -> (pcm, state)) over the rotated
    batches: one untimed group, then sz.repeats windows of
    timed_steps(steps) back-to-back steps, each closed by one
    synchronize.  Each step's PCM is let go.  {"rtf": [per window],
    "steps": all steps run}."""
    n = timed_steps(sz, steps)

    def run(count, state):
        for k in range(count):
            _, state = one(batches[k % len(batches)], state)
        sync(dev)
        return state

    state = run(sz.group, state)
    rtf = []
    for _ in range(sz.repeats):
        t0 = time.perf_counter()
        state = run(n, state)
        rtf.append(B * n * samples / rate / (time.perf_counter() - t0))
    return {"rtf": rtf, "steps": sz.group + sz.repeats * n}


def measure(pool, B: int, path: str, exact: bool, steps: int, sz: Sizes,
            dev, rate: float = 44100.0) -> dict:
    """bench.py ``_measure`` (and ``_measure_lsf`` with an LSF pool at
    22,050 Hz): the device-resident rate of one (route, precision, B)."""
    from .models import decoder as M

    batches = [tile_batch(b, B) for b in pool[:4]]
    return windows(step_fn(path, exact), batches, M.init_state(B, dev), B,
                   576, rate, steps, sz, dev)


def measure_l12(B: int, steps: int, sz: Sizes, dev) -> dict:
    """bench.py ``_measure_l12``: the Layer II synthesis step (K7 fast
    on CUDA, its plain version on the CPU; the JAX package runs it as
    XLA ops), 1152 samples a frame at 44.1 kHz."""
    from .models.l12 import (batch_from_frames, decode_l12_frames,
                             init_l12_state)

    pool = [tuple(torch.from_numpy(a).to(dev)
                  for a in batch_from_frames([fd] * B, layer=2))
            for fd in l12_frames()]

    def one(p, state):
        return decode_l12_frames(*p, state, exact=False)

    return windows(one, pool, init_l12_state(B, dev), B, 1152, 44100.0,
                   steps, sz, dev)


# ---- attestations ----

def attest_kernel_vs_split(pool, dev, B: int = 1024) -> dict:
    """bench.py ``_attest_pallas_vs_xla``: the kernel route against the
    split route on the device, four granules at B slots from zero state;
    exact: PCM and state bitwise equal; fast: the largest PCM difference
    in LSB (the two sum in another order)."""
    from .models import decoder as M

    res = {}
    for exact in (True, False):
        st_k, st_s = M.init_state(B, dev), M.init_state(B, dev)
        kern, split = step_fn("kernel", exact), step_fn("split", exact)
        equal, worst = True, 0
        for b in pool[:4]:
            batch = tile_batch(b, B)
            pk, st_k = kern(batch, st_k)
            ps, st_s = split(batch, st_s)
            equal &= torch.equal(pk, ps)
            worst = max(worst, int((pk.long() - ps.long()).abs().max()))
        if exact:
            res["kernel_exact_bitexact_vs_split_on_gpu"] = bool(
                equal and all(torch.equal(
                    getattr(st_k, n).view(torch.int32),
                    getattr(st_s, n).view(torch.int32))
                    for n in ("store", "v_blocks", "prev_lines")))
        else:
            res["kernel_fast_max_lsb_vs_split_on_gpu"] = worst
    return res


def attest_exact(dev) -> dict:
    """bench.py ``_attest_exact_vs_reference`` on its two streams
    (ATTEST_STREAMS): ``TorchDSP(exact=True)`` byte-equal to the native decoder,
    always, and to the reference binary where it builds (else null, with
    the reason in ``reference_status``).  ``decoded_frames``: the frames
    TorchDSP decoded (two K4 launches each)."""
    from .api import decode_file
    from .host import native_decode_file
    from .models.decoder import TorchDSP
    from .testing import golden, mp3gen

    status = golden.reference_status()
    native_ok = ref_ok = True
    frames = 0
    for spec in ATTEST_STREAMS:
        s = mp3gen.make_stream(**spec)
        got = decode_file(s, dsp=TorchDSP(exact=True, device=dev))
        frames += len(got) // FRAME_BYTES
        native_ok &= len(got) > 0 and got == native_decode_file(s)
        if status == "built":
            ref_ok &= got == golden.reference_decode(s)
    return {"exact_bitexact_vs_native_on_gpu": bool(native_ok),
            "exact_bitexact_vs_reference_on_gpu":
            bool(ref_ok) if status == "built" else None,
            "reference_status": status, "decoded_frames": frames}


# ---- the serving pools ----

def _refill(dec, src: list[bytes], pos: list[int]) -> None:
    """bench.py's per-slot refill: top up each slot's ring by up to 4 KB
    of its looping source."""
    for s in range(len(src)):
        if pos[s] >= len(src[s]):
            pos[s] = 0
        if dec.inbuf_free(s) >= 4096:
            n = min(4096, len(src[s]) - pos[s])
            dec.feed(s, src[s][pos[s]:pos[s] + n])
            pos[s] += n


def bench_e2e_ab(streams, dev, B: int = 4096, trials: int = 3,
                 seconds: float = 3.0) -> dict:
    """bench.py ``_bench_e2e_ab``: the full pipeline (native parse at one
    thread, wire upload, K1) over distinct streams, dense and sparse
    wire in interleaved trials ("dense": ``StreamDecoder``, whose MPEG-1
    wire is the coded one, widened by K10 a step).  {"dense", "sparse":
    RTF per trial, "dense_bpg", "sparse_bpg": wire bytes a granule,
    "decode_steps", "dense_steps": those of the dense pool}."""
    from .runtime import SparseStreamDecoder, StreamDecoder

    wires = ("dense", "sparse")
    decs = {w: (SparseStreamDecoder if w == "sparse" else StreamDecoder)(
        B, exact=False, device=dev) for w in wires}
    src = [streams[i % len(streams)] for i in range(B)]
    pos = {w: [0] * B for w in wires}
    steps = dict.fromkeys(wires, 0)
    for w in wires:  # warm the pools and the sticky buckets
        for _ in range(4):
            _refill(decs[w], src, pos[w])
            decs[w].parse_step()
        steps[w] += decs[w].decode_step(fetch=False) is not None
    sync(dev)
    out = {w: [] for w in wires}
    for _ in range(trials):
        for w in wires:
            dec = decs[w]
            granules = wire_bytes = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                _refill(dec, src, pos[w])
                na = dec.parse_step()
                if na == 0:
                    continue
                wire_bytes += dec.wire_bytes()
                dec.decode_step(fetch=False)
                steps[w] += 1
                granules += 2 * na
            sync(dev)
            el = time.perf_counter() - t0
            out[w].append(granules * 576 / 44100.0 / el)
            out[f"{w}_bpg"] = wire_bytes / max(granules, 1)
    out["decode_steps"] = sum(steps.values())
    out["dense_steps"] = steps["dense"]
    return out


def bench_drain_ab(streams, dev, B: int = 2048, trials: int = 9,
                   seconds: float = 5.0) -> dict:
    """bench.py ``_bench_drain_ab``: the synchronous PCM fetch a step
    (``decode_step(fetch=True)``) against the pipelined drain
    (``decode_step_pipelined``, the copy on a side stream one step
    late), interleaved trials: RTF per trial, IQRs and ``decisive`` (the
    IQRs do not overlap)."""
    from .runtime import LoopFeeder, StreamDecoder

    decs = {k: StreamDecoder(B, exact=False, device=dev)
            for k in ("sync", "async")}
    feeders = {k: LoopFeeder(decs[k], streams) for k in decs}
    steps = 0
    for k, dec in decs.items():
        feeders[k].step()
        dec.parse_step()
        steps += dec.decode_step() is not None
    rates = {k: [] for k in decs}
    for _ in range(trials):
        for k, dec in decs.items():
            granules = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                feeders[k].step()
                na = dec.parse_step()
                if na == 0:
                    continue
                if k == "sync":
                    dec.decode_step(fetch=True)
                else:
                    dec.decode_step_pipelined()
                steps += 1
                granules += 2 * na
            if k == "async":
                dec.drain_pending()
            el = time.perf_counter() - t0
            rates[k].append(granules * 576 / 44100.0 / el)
    out = {"trials": rates, "decode_steps": steps}
    for k, v in rates.items():
        q1, q3 = (float(np.percentile(v, p)) for p in (25, 75))
        out[f"{k}_iqr"] = [round(q1, 1), round(q3, 1)]
    out["decisive"] = bool(out["async_iqr"][0] > out["sync_iqr"][1]
                           or out["sync_iqr"][0] > out["async_iqr"][1])
    return out


def bench_serving_at_size(dev, B: int = 4096, steps: int = 24,
                          trials: int = 5) -> dict:
    """bench.py ``_bench_serving_at_size``: B distinct streams in B
    slots.  The host side: feed and parse ms a step (median of RECORDED
    steps, one core).  The device side: RECORDED parsed wires recorded
    and replayed, with no parse; first replayed from the state before
    they were decoded live, their PCM held bitwise against the live
    steps', then `trials` windows of `steps` replays.  A replayed step
    (``replay_step_ms``, host clock; bench.py's ``device_step_ms_tunnel``)
    is the host copy of its recorded wire into the pool's pinned buffer,
    after that buffer's upload fence (``host_copy_ms_per_step``), and
    then ``decode_step``: the upload and
    two K1 launches (``device_step_ms``, CUDA events around them; the
    host clock off CUDA).  ``device_feed_only_rtf`` is bench.py's, over
    the replayed step."""
    from .models.decoder import DecoderState
    from .runtime import LoopFeeder, StreamDecoder

    streams = corpus(at_size_spec, B)
    dec = StreamDecoder(B, exact=False, device=dev)
    feeder = LoopFeeder(dec, streams)
    feeder.step()
    dec.parse_step()
    dec.decode_step()
    n_steps = 1
    st0 = DecoderState(*(getattr(dec.state, n).clone()
                         for n in ("store", "v_blocks", "prev_lines")))
    t_feed, t_parse, recorded, live = [], [], [], []
    for _ in range(RECORDED):
        t0 = time.perf_counter()
        feeder.step()
        t_feed.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dec.parse_step()
        t_parse.append(time.perf_counter() - t0)
        recorded.append(dec.wire.copy())    # active and meta included
        live.append(dec.decode_step(fetch=False))
        n_steps += 1

    def copy_in(k):
        # into the buffer that the next upload reads, as parse_step
        # writes it: the race of a pinned double buffer (a queued
        # non_blocking upload reads the buffer when the stream reaches
        # it) lets the host write it only once its fence has passed
        dec._reclaim()
        dec._sets[dec._cur]["wire"][...] = recorded[k % len(recorded)]
        dec._show(dec._cur)

    for n in ("store", "v_blocks", "prev_lines"):
        getattr(dec.state, n).copy_(getattr(st0, n))
    again = []
    for k in range(RECORDED):
        copy_in(k)
        again.append(dec.decode_step(fetch=False))
    matches = all(a is not None and b is not None and torch.equal(a, b)
                  for a, b in zip(again, live))
    del again, live
    n_steps += RECORDED
    cuda = dev.type == "cuda"
    t_replay, t_copy, t_dev = [], [], []
    for _ in range(trials):
        copy_s = dev_s = 0.0
        marks = []
        t0 = time.perf_counter()
        for k in range(steps):
            t1 = time.perf_counter()
            copy_in(k)
            t2 = time.perf_counter()
            copy_s += t2 - t1
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record(torch.cuda.current_stream(dev))
                dec.decode_step(fetch=False)
                ev[1].record(torch.cuda.current_stream(dev))
                marks.append(ev)
            else:
                dec.decode_step(fetch=False)
                dev_s += time.perf_counter() - t2
        sync(dev)
        t_replay.append((time.perf_counter() - t0) / steps)
        t_copy.append(copy_s / steps)
        if cuda:
            dev_s = sum(a.elapsed_time(b) for a, b in marks) / 1e3
        t_dev.append(dev_s / steps)
        n_steps += steps
    feed_s, feed_r = spread(t_feed)
    parse_s, parse_r = spread(t_parse)
    replay_s, replay_r = spread(t_replay)
    copy_s, copy_r = spread(t_copy)
    dev_s, dev_r = spread(t_dev)
    frame_period = 1152 / 44100.0
    return {"line": {
        "distinct_streams": B,
        "feed_ms_per_step": round(feed_s * 1e3, 3),
        "parse_ms_per_step": round(parse_s * 1e3, 3),
        "host_streams_per_core_realtime":
            round(B * frame_period / (feed_s + parse_s), 1),
        "replay_step_ms": round(replay_s * 1e3, 4),
        "host_copy_ms_per_step": round(copy_s * 1e3, 4),
        "device_step_ms": round(dev_s * 1e3, 4),
        "device_feed_only_rtf": round(B * frame_period / replay_s, 1),
        "replay_matches_live": matches},
        "ranges": {"feed_ms_per_step": [x * 1e3 for x in feed_r],
                   "parse_ms_per_step": [x * 1e3 for x in parse_r],
                   "replay_step_ms": [x * 1e3 for x in replay_r],
                   "host_copy_ms_per_step": [x * 1e3 for x in copy_r],
                   "device_step_ms": [x * 1e3 for x in dev_r]},
        "decode_steps": n_steps}


def bench_e2e_lsf(dev, B: int = 1024, trials: int = 3,
                  seconds: float = 1.0, n_distinct: int = 32) -> dict:
    """bench.py ``_bench_e2e_lsf``: a sparse MPEG-2 pool (native LSF
    parse, sparse LSF wire, K3) over 32 streams, RTF at 22.05 kHz per
    trial."""
    from .runtime import SparseStreamDecoder

    streams = corpus(lsf_spec, n_distinct)
    dec = SparseStreamDecoder(B, exact=False, family=1, device=dev)
    src = [streams[i % len(streams)] for i in range(B)]
    pos = [0] * B
    for _ in range(4):  # warm the pool and the sticky bucket
        _refill(dec, src, pos)
        dec.parse_step()
    steps = int(dec.decode_step(fetch=False) is not None)
    sync(dev)
    rtf = []
    for _ in range(trials):
        granules = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            _refill(dec, src, pos)
            na = dec.parse_step()
            if na == 0:
                continue
            dec.decode_step(fetch=False)
            steps += 1
            granules += na
        sync(dev)
        rtf.append(granules * 576 / 22050.0 / (time.perf_counter() - t0))
    return {"rtf": rtf, "decode_steps": steps}


# ---- the host ----

def bench_single_core(trials: int = 3, seconds: float = 1.0) -> dict:
    """bench.py ``_bench_single_core``: frames per second of the native
    scalar decoder on one 200-frame stream, and of the reference binary
    where it builds (else null, with ``reference_status``), per trial."""
    from .host import native_decode_file
    from .testing import golden, mp3gen

    stream = mp3gen.make_stream(n_frames=200, seed=9, blocks="varied",
                                mode=1, mode_extension=2,
                                use_reservoir=True)

    def rate(fn):
        n = 0
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            fn()
            n += 1
        return n * 200 / (time.perf_counter() - t0)

    native = [rate(lambda: native_decode_file(stream))
              for _ in range(trials)]
    status = golden.reference_status()
    ref = None
    if status == "built":
        binpath = golden.ensure_reference_binary()
        with tempfile.TemporaryDirectory() as d:
            mp3 = os.path.join(d, "b.mp3")
            with open(mp3, "wb") as f:
                f.write(stream)

            def one():
                subprocess.run([binpath, mp3], cwd=d, capture_output=True,
                               check=True)
                os.remove(mp3 + ".raw")
            ref = [rate(one) for _ in range(trials)]
    return {"native": native, "reference": ref, "reference_status": status}


def bench_parse(dev, B: int = 256, trials: int = 3,
                seconds: float = 1.0) -> list[float]:
    """bench.py ``_bench_parse``: frames per second through the serving
    parse (``LoopFeeder.step`` + ``parse_step``, one thread) over 8
    looping 60-frame streams, per trial."""
    from .runtime import LoopFeeder, StreamDecoder
    from .testing import mp3gen

    streams = [mp3gen.make_stream(n_frames=60, seed=40 + i, blocks="varied",
                                  mode=1, mode_extension=2,
                                  use_reservoir=True) for i in range(8)]
    dec = StreamDecoder(B, exact=False, parse_threads=1, device=dev)
    feeder = LoopFeeder(dec, streams)
    feeder.step()
    dec.parse_step()  # warm cold pages out of the timed window
    out = []
    for _ in range(trials):
        frames = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            feeder.step()
            frames += dec.parse_step()
        out.append(frames / (time.perf_counter() - t0))
    return out


def h2d_gbps(B: int, dev, trials: int = 5) -> list[float] | None:
    """Host-to-device rate of a [B, 2, 576] int16 tensor in pinned
    memory (what the pools upload from), per trial; None off CUDA."""
    if dev.type != "cuda":
        return None
    x = torch.zeros((B, 2, 576), dtype=torch.int16, pin_memory=True)
    x.to(dev)
    sync(dev)
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        x.to(dev, non_blocking=True)
        sync(dev)
        out.append(x.numel() * 2 / (time.perf_counter() - t0) / 1e9)
    return out


# ---- the run ----

def run(sz: Sizes, dev) -> dict:
    """Every measurement and attestation; the JSON line as a dict.  On
    CUDA each measurement's kernel launches (``tools.launches``) must be
    what its steps ran, else RuntimeError; on the CPU, none.

    At its default sizes the corpora are made by spawned processes
    (``tools.feasible_streams``), which import the caller's ``__main__``
    again: a script that calls run needs an ``if __name__ ==
    "__main__":`` guard."""
    by = {}

    def counted(name: str, want, fn, *args, **kw):
        before = launches()
        res = fn(*args, **kw)
        got = launched_since(before)
        expect = {k: n for k, n in want(res).items() if n}
        if got != (expect if dev.type == "cuda" else {}):
            raise RuntimeError(f"bench {name}: launched {got}, want "
                               f"{expect}")
        by[name] = got
        return res

    def one_per_step(kernel):
        """A window's launches: one of `kernel` a granule step."""
        return lambda r: {kernel: r["steps"]}

    pool = build_pool(dev)
    sweep = {B: counted(f"kernel_fast_B{B}", one_per_step("fused_granule"),
                        measure, pool, B, "kernel", False, sz.steps, sz,
                        dev)
             for B in sz.sweep}
    B = max(sweep, key=lambda b: spread(sweep[b]["rtf"])[0])
    rates = {("kernel", False): sweep[B]}
    for path, exact, kernel in (("split", False, "back_half"),
                                ("kernel", True, "fused_granule_exact"),
                                ("split", True, "back_half")):
        rates[(path, exact)] = counted(
            f"{path}_{'exact' if exact else 'fast'}", one_per_step(kernel),
            measure, pool, B, path, exact, sz.steps, sz, dev)
    med = {k: spread(v["rtf"])[0] for k, v in rates.items()}
    rtf = max(med[("kernel", False)], med[("split", False)])
    exact_rtf = max(med[("kernel", True)], med[("split", True)])
    granules_per_sec = rtf * 44100.0 / 576
    step_ms = B / granules_per_sec * 1000.0

    attest = counted("attest_kernel_vs_split", lambda r: {
        "fused_granule": 4, "fused_granule_exact": 4, "back_half": 8},
        attest_kernel_vs_split, pool, dev)
    ex = counted("attest_exact", lambda r: {
        "back_half": 2 * r["decoded_frames"]}, attest_exact, dev)
    h2d = h2d_gbps(B, dev, sz.repeats)

    streams = corpus(e2e_spec, sz.e2e_distinct)
    ab = counted("e2e_ab", lambda r: {"fused_granule":
                                      2 * r["decode_steps"],
                                      "l3_expand": r["dense_steps"]},
                 bench_e2e_ab, streams, dev, sz.e2e_slots, sz.e2e_trials,
                 sz.e2e_seconds)
    drain = counted("drain_ab", lambda r: {"fused_granule":
                                           2 * r["decode_steps"],
                                           "l3_expand": r["decode_steps"]},
                    bench_drain_ab, streams, dev, sz.drain_slots,
                    sz.drain_trials, sz.drain_seconds)
    at_size = counted("serving_at_size", lambda r: {
        "fused_granule": 2 * r["decode_steps"],
        "l3_expand": r["decode_steps"]}, bench_serving_at_size,
        dev, sz.at_size_slots or B, sz.at_size_steps, sz.repeats)
    single = counted("single_core", lambda r: {}, bench_single_core,
                     sz.host_trials, sz.host_seconds)
    parse = counted("parse", lambda r: {}, bench_parse, dev,
                    trials=sz.host_trials, seconds=sz.host_seconds)
    lsf = counted("lsf_kernel_fast", one_per_step("fused_granule_lsf"),
                  measure, lsf_pool(dev), B, "kernel", False,
                  sz.short_steps, sz, dev, rate=22050.0)
    lsf_e2e = counted("e2e_lsf", lambda r: {"fused_granule_lsf":
                                            r["decode_steps"]},
                      bench_e2e_lsf, dev, sz.lsf_e2e_slots,
                      sz.host_trials, sz.host_seconds, sz.lsf_distinct)
    l12 = counted("l12", one_per_step("l12_synth"), measure_l12, B,
                  sz.short_steps, sz, dev)

    ranges = {}

    def med_of(key, xs):
        m, ranges[key] = spread(xs)
        return round(m, 1)

    line = {
        "metric": "aggregate_realtime_factor_per_chip",
        "value": round(rtf, 1),
        "unit": "x_realtime_44k1_stereo",
        "vs_baseline": round(rtf / 10000.0, 3),
        "fastest_path": ("kernel" if med[("kernel", False)]
                         >= med[("split", False)] else "split"),
        "kernel_rtf": med_of("kernel_rtf", rates[("kernel", False)]["rtf"]),
        "split_rtf": med_of("split_rtf", rates[("split", False)]["rtf"]),
        "exact_rtf": round(exact_rtf, 1),
        "kernel_exact_rtf": med_of("kernel_exact_rtf",
                                   rates[("kernel", True)]["rtf"]),
        "split_exact_rtf": med_of("split_exact_rtf",
                                  rates[("split", True)]["rtf"]),
        "batch_slots": B,
        "steps": sz.steps,
        "step_ms": round(step_ms, 4),
        "granules_per_sec": round(granules_per_sec, 1),
        "kernel_sweep_rtf": {str(b): round(spread(r["rtf"])[0], 1)
                             for b, r in sweep.items()},
        **attest,
        "exact_bitexact_vs_reference_on_gpu":
            ex["exact_bitexact_vs_reference_on_gpu"],
        "exact_bitexact_vs_native_on_gpu":
            ex["exact_bitexact_vs_native_on_gpu"],
        "reference_status": ex["reference_status"],
        "e2e_serving_rtf_sparse_kernel": med_of(
            "e2e_serving_rtf_sparse_kernel", ab["sparse"]),
        "e2e_rtf_drain_sync": med_of("e2e_rtf_drain_sync",
                                     drain["trials"]["sync"]),
        "e2e_rtf_drain_async": med_of("e2e_rtf_drain_async",
                                      drain["trials"]["async"]),
        "e2e_drain_sync_iqr": drain["sync_iqr"],
        "e2e_drain_async_iqr": drain["async_iqr"],
        "e2e_drain_ab_decisive": drain["decisive"],
        "e2e_drain_ab_method": f"{sz.drain_trials} interleaved trials x "
                               f"{sz.drain_seconds:g} s; decisive = "
                               "non-overlapping IQRs",
        "e2e_serving_rtf_dense_kernel": med_of(
            "e2e_serving_rtf_dense_kernel", ab["dense"]),
        "e2e_method": f"interleaved dense/sparse trials, medians "
                      f"({sz.e2e_trials} trials/config)",
        "parse_threads": 1,
        "wire_bytes_per_granule_dense": round(ab["dense_bpg"], 1),
        "wire_bytes_per_granule_sparse": round(ab["sparse_bpg"], 1),
        "e2e_distinct_streams": sz.e2e_distinct,
        "serving_at_size": at_size["line"],
        "lsf_rtf_kernel_22k05": med_of("lsf_rtf_kernel_22k05", lsf["rtf"]),
        "e2e_lsf_sparse_kernel_rtf_22k05": med_of(
            "e2e_lsf_sparse_kernel_rtf_22k05", lsf_e2e["rtf"]),
        "l12_rtf_layer2_44k1": med_of("l12_rtf_layer2_44k1", l12["rtf"]),
        "native_singlecore_frames_per_sec": med_of(
            "native_singlecore_frames_per_sec", single["native"]),
        "host_parse_frames_per_sec_1t": med_of(
            "host_parse_frames_per_sec_1t", parse),
        "reference_binary_frames_per_sec": (
            med_of("reference_binary_frames_per_sec", single["reference"])
            if single["reference"] else None),
        "h2d_gbps": (round(spread(h2d)[0], 3) if h2d else None),
        "device": card(dev),
        "note": ("device-resident decode rate on one GPU: granule "
                 "tensors, PCM and state in device memory, launches "
                 "back to back, one synchronize per window; the e2e_* "
                 "keys run the serving pools at parse_threads native "
                 "parse threads, so they measure the host's parse, not "
                 "the card; medians over trials, ranges = [min, max]"),
        "precision": ("headline = fast (f32, within 1 LSB of the "
                      "reference); exact_rtf = bit-exact, attested on "
                      "this device against the native decoder and, "
                      "where it builds, the reference binary"),
    }
    ranges["kernel_sweep_rtf"] = {str(b): spread(r["rtf"])[1]
                                  for b, r in sweep.items()}
    ranges["serving_at_size"] = at_size["ranges"]
    if h2d:
        ranges["h2d_gbps"] = spread(h2d)[1]
    line["ranges"] = ranges
    total = {}
    for got in by.values():
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    line["launches"] = {"total": total, "by_measurement": by}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int,
                    help="one batch size instead of the sweep "
                         f"{Sizes.sweep}")
    ap.add_argument("steps", nargs="?", type=int, default=Sizes.steps,
                    help="granule steps a timed window (whole groups of "
                         f"{K})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sz = Sizes(steps=args.steps,
               **({"sweep": (args.batch,)} if args.batch else {}))
    print(json.dumps(run(sz, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
