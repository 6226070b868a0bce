#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Layer III decoding through ``pdmp3_tpu_torch`` at B = 8192 stream slots,
fast and exact, MPEG-1 and the LSF families MPEG-2 and MPEG-2.5, one
granule per launch and one frame per launch, dense and sparse wire, S16
and float PCM; Layer I/II pools, mid-stream joins, the resampler and
batched and offline file decode; sharded pools over shards of the card,
two processes serving one pool over torch.distributed, and the entry
step; then the port's tools (``pdmp3_tpu_torch/tools/``) at their real
sizes: the serving diff, the 102,400-slot scale simulation, the wire
profile, a four-rank soak, the parse sweep, the resample sweep and the
differential soak; then float PCM of the LSF families at the model
level; then the port's bench (``pdmp3_tpu_torch.bench``) at
turned-down sizes; thirty-six phases in all (phase 37, the coded
wire's widening, runs first; phase 34, the float granule instances,
beside phases 2 and 10; phases 35-36, the Layer I/II synthesis and
resampler kernels, before phase 18), and any failure exits non-zero.  The kernels
are built here from ``pdmp3_tpu_torch/csrc`` and the port's native host
library from ``pdmp3_tpu_torch/host/src``.

1. the card's name and power limit, then a check that CUDA is visible;
2. K1, the fast granule kernel, against its plain PyTorch version on the
   same CUDA tensors: one frame (two granule steps) of natively parsed
   wire, a few idle slots, a random starting state, at B and at the
   ragged B = 2 x grid + 3 (grid: K1's persistent grid, SM count x
   resident blocks); both timed; K1's launch geometry (grid, blocks per
   SM, shared memory, registers, local bytes) printed;
3. the fast main path: ``StreamDecoder(8192, device="cuda")`` fed by
   ``LoopFeeder`` from 64 distinct generated streams, 2 warm-up and 32
   timed frame steps of feed -> parse_step -> decode_step, with K1's
   launch count checked against the steps run;
4. the PCM of slots covering long, short, mixed, MS, intensity, mono,
   32 and 48 kHz streams against the native scalar C++ decoder;
5. K2, the exact granule kernel, against its plain version as in phase
   2 (B and the ragged B), and on a directed granule whose band-12 carry
   holds subnormal bit patterns (denormal band-12 gains); bitwise, both
   timed;
6. the exact main path: phase 3 with ``exact=True`` (K2), and its
   watched slots bitwise equal to the native decoder;
7. K4, the back-half kernel, against its plain version in both modes on
   one frame's post-antialias spectra, at B and at one slot (the shape
   the per-stream route launches it at), bitwise and timed, with the
   launch geometry of both instances; one step of the batched split
   route (``decode_granules``: stage ops + K4 + the pack) timed at B in
   both modes; then the fused exact route (K2) against the split one
   (stage ops + K4 + the f64 quantize), bitwise;
8. the per-stream route: ``pdmp3_tpu_torch.api.decode_file`` with
   ``TorchDSP(device="cuda")`` (K4) on 6 generated streams, exact
   byte-equal to the native decoder and fast within 1 LSB;
9. K6: the exact kernel's three float64 rounding points over all 2^32
   f32 inputs on the card, all three from one launch per 2^24-input
   chunk, against their plain f64 versions, bitwise; one chunk timed
   with the three-construction launch and with each construction's own;
10. K3, the LSF granule kernel, fast and exact, against its plain version
    on one natively parsed LSF step per family (MPEG-2, MPEG-2.5), at B
    and at the ragged B = 2 x grid + 3 (K3's grid) with the is_pos
    sidecar at an address that is 4-byte but not 16-byte aligned;
    bitwise, both timed, K3's launch geometry printed;
11. the LSF serving pools: ``StreamDecoder(8192, family=f, exact=e,
    device="cuda")`` for both families and precisions, fed by
    ``LoopFeeder`` from 64 distinct 12-frame LSF streams each, 2 warm-up
    and 32 timed steps, K3's launch count checked, and the watched slots
    against the native decoder with PROFILE_LSF (exact bitwise, fast
    within 1 LSB);
12. the per-stream route on LSF: ``decode_file(s, lsf=True,
    dsp=TorchDSP(...))`` (K4) on 6 LSF streams, exact byte-equal to the
    native decoder and fast within 1 LSB;
14. K5, the frame kernel, against its plain version (the plain granule
    step chained): phase 2's MPEG-1 frame (parities (0, 1), slots idle
    in both granules or in the second only), a directed band-12 fixture
    whose carry holds small subnormal bit patterns, and each LSF
    family's frame taken twice (parities (0, 0)), at B and at the ragged
    B = 2 x grid + 3 (K5's grid); bitwise, timed, K5's launch geometry
    printed, and timed against two K1 launches interleaved in the same
    run, and K5 at ng = 1 (granule 0 alone) against one K1 launch,
    interleaved;
15. frame-fused serving: phase 3 with ``models.decoder._FRAME_FUSED``
    set, K5 once per frame step and no K1, its watched slots byte-equal
    to phase 3's; the device replay of both routes interleaved;
16. ``SparseStreamDecoder(8192, frames_per_step=2)``, frame-fused, with
    the pipelined PCM drain (``decode_step_pipelined`` /
    ``drain_pending``): the watched slots byte-equal to phase 3's, and
    the sparse wire's bytes per step beside the dense wire's;
17. float PCM: K4's fast raw-sums instance (8) against its plain version
    (``back_half_step_ref(raw=True)``) on phase 2's frame at B, at one
    slot and at the ragged B = 2 x grid + 3 with idle slots at the seams
    of its slot ring, bitwise, timed, its launch geometry printed; then
    ``StreamDecoder(8192, float_pcm=True, device="cuda")`` fast (K1's
    float instance 9) and exact (K2's, 10) on phase 3's streams, 2
    warm-up and 10 timed steps, every slot of every step bitwise equal
    to ``decode_granules(float_pcm=True)`` on the step's wire (the stage
    ops and K4, instance 8 fast, 7 exact), both routes' launches
    checked; the watched slots' trunc(pcm x 32767) equal to phase 6's
    S16 PCM (exact) or within 1.001/32767 of phase 3's / 32767 (fast),
    but at the wrap;
18. Layer I/II pools: ``L12StreamDecoder(8192, layer=l, exact=e,
    device="cuda")`` for both layers and precisions, fed by ``LoopFeeder``
    from 64 generated 12-frame streams per layer (stereo and mono,
    several bitrates, the three MPEG-1 rates), 2 warm-up and 10 timed
    steps, K7 launched once a step (and once a replayed step) in the
    pool's instance; watched slots against the native decoder with
    PROFILE_L12 (exact bitwise, fast within 1 LSB); Layer II float PCM,
    exact and fast, within 1.001/32767 of the S16 of its precision;
19. mid-stream joins: in a serving pool, fast and exact, two slots each
    joined to new streams at 0.1-0.3 s (``StreamDecoder.join``); after
    ``drop_samples`` each slot's PCM is the same window of the native
    decode (exact bitwise, fast within 1 LSB);
20. the resampler: ``StreamDecoder(8192, resample_to=48000,
    sample_rate=44100, device="cuda")`` on a 44.1 kHz corpus, each
    step's length as the phase gives it, the watched slots within 1 LSB
    of the same resampler run on the CPU over their S16 PCM; K8 once a
    step; the resample step timed;
21. file decode: ``decode_files_batched`` over 1,024 files (phase 3's 64
    streams x 16), exact, and with gapless=True, window=(0.1, 0.2) on
    64 of them and layer=2 on 64 Layer II files (K7 exact once a frame
    step); ``decode_files_scan`` over the 1,024 files, exact; every
    64th file (every file of the 64-file runs) bitwise against the
    native decoder, its window or trim; files and audio seconds per wall
    second;
22. sharded serving: ``ShardedStreamDecoder(8192, make_mesh(["cuda:0"]
    * 2), ...)`` MPEG-1 fast (K1) and exact (K2) on phase 3's streams,
    MPEG-2 exact (K3) on phase 11's family-1 streams, and
    ``ShardedL12StreamDecoder`` Layer II exact on phase 18's, each in
    lockstep with the unsharded pool fed alike (``LoopFeeder``), the
    pool that steps first alternating: every step's PCM bitwise equal to
    the unsharded pool's, the kernel launched per frame step twice per
    shard (MPEG-1) or once (MPEG-2, Layer II: K7), the watched slots
    against the
    native decoder; step_ms, device_replay_step_ms and loop_ms_per_step
    of both pools (each pool's step between two synchronisations); then
    both pools on ``decode_step_pipelined`` in lockstep, every returned
    step and the ``drain_pending`` flush bitwise equal, the launches
    checked, and each pool's free-running pipelined and synchronous
    loops timed in alternation; and ``decode_granules_sharded`` on a
    parsed granule at B with a random state: PCM and state bitwise the
    unsharded K1 step's, the same clipped count;
23. two processes: two spawned ranks on cuda:0 joined by gloo over
    localhost TCP, each ``MultiHostStreamDecoder(8192, device="cuda:0",
    exact=True)`` over its 4,096 slots with half the host's cores as
    parse threads, stepped until ``global_active`` reads 0: K2 twice per
    step, the watched slots bitwise against the native decoder, each
    rank's loop ms per step (the ranks time-slice one card); a rank that
    fails or outlives its timeout fails the run, and the others are
    killed;
24. the entry step: ``entry.entry("cuda")``'s step launches K1 once and
    equals its plain version bitwise; ``entry.dryrun_multichip(4,
    "cuda")`` (MPEG-1, MPEG-2 and Layer II over four shards of the card
    against their unsharded steps) passes, launching K1, K3 and K7 once
    per shard and once unsharded;
25. the serving diff (``tools.serving_diff``): 512 random MPEG-1 streams
    (the JAX tool's generator and seed base) drip-fed into
    ``SparseStreamDecoder(512)``, fast (K1) then exact (K2), each stream
    against native (and the reference binary where it builds): exact 0
    LSB on every stream, fast <= 1 LSB on < 1%, each kernel twice per
    step;
26. the scale simulation (``tools.scale_sim``): ``BASELINE.json``
    configs[4]'s 100k-stream step at 102,400 slots over 8 shards of the
    card, 3 timed K1 steps on every shard, slots 0-3, B/2, B/2+1, B-4
    and B-1 bitwise against a 4-slot decode; step ms (CUDA events) and
    peak memory;
27. the wire profile (``tools.wire_profile``): dense against sparse
    wire at B on phase 3's streams, parse / upload / decode / drain per
    step, wire bytes, the sparse bucket trajectory and two alternating
    trials of the pipelined loop;
28. a multi-process soak round (``tools.multihost_soak``) whose draw
    gives four spawned ranks on the card, exact (K2), every slot bitwise
    against native; a failed or late rank kills the others and fails
    the run;
29. the parse sweep (``tools.parse_scaling``): the native parse
    benchmark at 8,192 slots, 1 s at 1, 2, 4, ... threads up to the
    host's cores, its stage split, the serving loop's parse rate, and
    the cores that feed the card at phase 2's K1 rate;
30. the resample sweep (``tools.resample_sweep``): every pair on the
    card at >= 85 dB passband SNR, with its ripple, K8 once a block;
31. the differential soak (``tools.soak``): 64 format-matrix streams,
    native against the oracle (and the reference where it builds),
    every 16th stream also ``TorchDSP(exact=True)`` on the card (K4);
32. LSF float PCM, per family and precision: K4 with raw sums (instance
    7 exact, 8 fast) against its plain version on one natively parsed
    LSF step's post-antialias spectra at B, at one slot and at the
    ragged B = 2 x grid + 3 with idle slots at the seams of its slot
    ring, bitwise, timed; then ``StreamDecoder(8192, family=f, exact=e)`` on phase
    11's corpus, 2 warm-up and 10 timed steps, each step's uploaded
    wire through ``decode_frame_packed_lsf(float_pcm=True)`` on a state
    of its own (K3's float instance, 11 fast or 12 exact, once a step),
    through ``decode_granules(float_pcm=True)`` on another (K4 once a
    step) and ``pool.advance`` (K3, once a step): every slot's float PCM
    bitwise equal to the split route's, and its trunc(pcm x 32767) equal
    to the S16 PCM (exact) or within 1.001/32767 of S16 / 32767 (fast),
    but at the wrap; the float, S16 and split steps timed with CUDA
    events;
33. the bench (``pdmp3_tpu_torch.bench.run``) with bench.py's sizes
    turned down (``BENCH_SIZES``: one batch size, B; two windows of 64
    granule steps; short trials; 256 distinct streams at size): its
    attestations true (K1 / K2 against the split route, exact PCM and
    state bitwise, fast within 1 LSB; exact ``TorchDSP`` byte-equal to
    native; the replayed at-size steps equal to the live ones), every
    rate finite and positive, and its launches: K1, K2, K3 and K4 once a
    granule step of each window (warm-up group included), K7 once a
    Layer II step, the attestations' and the pools' as counted;
34. the float granule instances 9-12 (K1, K2 and K3 with float PCM)
    against their plain version (``fused_granule_step_ref(
    float_pcm=True)``), after phase 17's kernel part on phase 2's frame
    (9, 10) and with phase 10 on each LSF family's step (11, 12): at B
    from the random state and from one whose FIFO rows drive five
    slots' sums to NaN, +-inf and past the rails, at the ragged B = 2 x
    grid + 3 with idle slots at the seams of the slot ring, MPEG-1 also
    on phase 5's subnormal band-12 carry; bitwise, timed, the launch
    geometry printed;
35. K9, the Layer I/II requantization kernel, against its plain version
    (``ops.l12_requant.l12_requant_ref``, on the card) on one natively
    parsed frame of phase 18's corpus per layer at B, as the pool's
    coded wire holds it, and on its first 1, 2 and 1,000 slots, bitwise,
    timed at B with its bound; then K7, the Layer I/II synthesis kernel,
    all eight instances (Layer I / II, fast / exact, S16 / float)
    against its plain version (``ops.l12_synth.l12_synth_step_ref``) on
    that frame as K9 requantizes it (nch a strided int16 view), from a
    random FIFO; on a FIFO whose rows drive five slots' sums to NaN,
    +-inf and past int32 with subnormal subband samples in one slot (the
    corpus has mono slots); on the hazards of K7's mirrored NWIN rows (a
    silent slot, rows whose dot with a unique row cancels to zero, +-0
    and subnormal samples, +-inf: the signed zeros and NaN bits of the
    FIFO count); at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3 with
    idle slots at the seams of the slot ring; PCM and FIFO bitwise;
    timed at B, the launch geometry printed;
36. K8, the resampler kernel, against its plain version
    (``ops.resample.resample_block_ref``) at B: int16 and f32 in and
    out, C = 1 and 2, five steps of 1,152, 576, 384, 10 (fewer than
    taps - 1) and 1,152 samples carrying the phase, 44.1 -> 48 kHz, and
    the same sizes cut from [B, N + 1, 2] at sample 1 (address and
    stream stride off 16-byte alignment: staged by plain loads in the
    kernel, where a serving block is bulk-staged); outputs, carries and
    phases bitwise; timed at the serving pool's shape (N = 1,152, C = 2,
    int16), its geometry printed;
37. K10, the widening of the MPEG-1 pool's coded wire (4-bit line codes
    and an escape list), against its plain version
    (``ops.l3_expand.l3_expand_ref``, on the card) on one natively
    parsed frame at B of phase 3's corpus and at 12,800 slots of the
    benchmark's LAME 128 kbps streams, as the pool uploads it, and on a
    generated wire of two frames at 12,800 slots with rows of 576
    escapes (|v| up to 8,206), silent rows and idle slot-frames: every
    line bitwise, one launch a call; timed with its bound at both sizes
    of parsed wire, its ptxas report printed (run before phase 2, whose
    frame the pool widens by the plain version).

The trace tools (``tools.drain_trace``, ``tools.kernel_trace``) and the
fuzzer (``tools.fuzz``) run as their own commands, not here: a
``torch.profiler`` session in a process that has run other work loses
launches on this card.

Each phase's wall seconds are printed before the kernels' line.

    python3 chip_smoke.py --profile

adds phase 13: ``torch.profiler`` over fast MPEG-1 serving steps
(device time by kernel and copy, and the device's busy share of the
loop), then the serving loop at 1, 2, 4 and 8 parse threads.

Kernel times come from ``pdmp3_tpu_torch/timing.py``: ``ms`` is the
device time per launch (CUDA events around replays of a CUDA graph that
holds the calls), ``burst_ms`` CUDA events around a burst of
back-to-back calls over the calls, ``per_call_ms`` events around one
call, its Python launcher included; plain versions and routes are timed in bursts.  The
line before the last is the kernels'
JSON record, each kernel with those times, its plain version's, and its
bound (the least time the card could take for the same work: the larger
of this run's bytes over the memory rate and its operations over the
peak rate of their type, NVIDIA's H100 SXM data sheet); the last line is
``{"ok": true, "device": {...}}``.  Nothing here imports JAX or the JAX
package.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 8192
# phase 37: the benchmark's pool size and its LAME 128 kbps streams
BENCH_SLOTS = 12800
LAME_44K1 = "benchmark/streams/lame_44k1_stereo.mp3"
N_STREAMS = 64
FRAMES_PER_STREAM = 12
WARMUP_STEPS = 2
TIMED_STEPS = 32
TIMED_LAUNCHES = 25
PLAIN_CALLS, PLAIN_BURSTS = 5, 3
PROFILE_STEPS = 8
PARSE_THREADS = (1, 2, 4, 8, 8, 4, 2, 1)   # two passes, mirrored
SWEEP_STEPS = 16
LSF_FAMILIES = (1, 2)
INACTIVE = (5, 77, 4099, B - 1)
# fast contract: at most 1 LSB, on fewer than 1% of samples
MAX_LSB, MAX_FRAC = 1, 0.01
# store / v tolerance: 1e-5 of the largest magnitude.  The kernel sums in
# the plain version's order and rounds where it rounds, so it is expected
# to match bit for bit; the bound only catches a wrong stage
STATE_RTOL = 1e-5
CSRC = "pdmp3_tpu_torch/csrc/"
# TPU kernels replaced (file:line of each kernel body)
REPLACES = {"fused_granule": "pdmp3_tpu/ops/pallas_step.py:771",
            "fused_granule_exact": "pdmp3_tpu/ops/pallas_step.py:771",
            "fused_granule_lsf": "pdmp3_tpu/ops/pallas_step.py:771",
            "fused_granule_lsf_exact": "pdmp3_tpu/ops/pallas_step.py:771",
            # the float instances 9-12 of K1, K2 and K3
            "fused_granule_float": "pdmp3_tpu/ops/pallas_step.py:771",
            "fused_granule_float_exact": "pdmp3_tpu/ops/pallas_step.py:771",
            "fused_granule_lsf_float": "pdmp3_tpu/ops/pallas_step.py:771",
            "fused_granule_lsf_float_exact":
            "pdmp3_tpu/ops/pallas_step.py:771",
            "back_half": "pdmp3_tpu/ops/pallas_step.py:463",
            "back_half_raw": "pdmp3_tpu/ops/pallas_step.py:463",
            "frame_fused": "pdmp3_tpu/ops/pallas_step.py:1067",
            "rounding_sweep": "tools/prove_on_tpu.py:88",
            # XLA stages of the JAX package, no Pallas kernel there: the
            # Layer I/II synthesis step (K7's four counters) and the
            # resampler's block (K8)
            "l12_synth": "pdmp3_tpu/models/l12.py:44",
            "l12_synth_exact": "pdmp3_tpu/models/l12.py:44",
            "l12_synth_float": "pdmp3_tpu/models/l12.py:44",
            "l12_synth_float_exact": "pdmp3_tpu/models/l12.py:44",
            "resample": "pdmp3_tpu/ops/resample.py:47",
            # K9 replaces no TPU kernel: the JAX package requantizes Layer
            # I/II on the host (its native parse_l2)
            "l12_requant": "pdmp3_tpu/host/src/frame.cc:1411",
            # nor K10: the JAX package's packer ships int16 lines
            "l3_expand": "pdmp3_tpu/host/src/api.cc:336"}
# the card's peak rates for the bounds (NVIDIA H100 SXM data sheet):
# memory bytes/s, f32 and f64 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# the subnormal band-12 bit patterns of phase 5's directed granule
SUBNORMAL_BITS = (126, 321)
# phase 8's streams: tests/test_jax_decoder.py CONFIGS (8 frames, seed 2)
API_CONFIGS = {
    "long": dict(blocks="long"),
    "varied_ms": dict(blocks="varied", mode=1, mode_extension=2),
    "ms_intensity": dict(blocks="long", mode=1, mode_extension=3,
                         stereo_extent_ch1=0.3, intensity_pos=True),
    "mono_48k": dict(blocks="varied", mode=3, sfreq=1),
    "mixed_32k": dict(blocks="mixed", sfreq=2),
    "reservoir_stuffing": dict(blocks="short", use_reservoir=True,
                               stuffing=4),
}
# phase 12's streams: tests/test_lsf.py JAX_MATRIX (8 frames, seed 31,
# bitrate index 11)
LSF_API_CONFIGS = {
    "m2-varied": dict(family=1, blocks="varied"),
    "m2-js-resv": dict(family=1, blocks="varied", mode=1, mode_extension=3,
                       stereo_extent_ch1=0.4, use_reservoir=True),
    "m2-mixed-24k": dict(family=1, blocks="mixed", sfreq=1),
    "m25-8k-is": dict(family=2, blocks="varied", sfreq=2, mode=1,
                      mode_extension=1, stereo_extent_ch1=0.3),
    "m25-short": dict(family=2, blocks="short"),
    "m2-mono": dict(family=1, blocks="long", mode=3),
}
# phase 14: a slot idle only in the frame's second granule, and the small
# subnormal bit patterns of the directed band-12 carry
IDLE_SECOND = 9
CARRY_BITS = (1, 40)
# phase 16: frames per step, and steps (with the warm-up) covering phase
# 3's frames
SPARSE_F = 2
SPARSE_STEPS = (WARMUP_STEPS + TIMED_STEPS) // SPARSE_F
# phases 17, 18 and 20: timed steps after the warm-up (with the warm-up,
# the 12 frames of a stream, which phase 18 compares with the native
# decoder), and phase 18's parse threads (its host parse, which
# requantizes, takes ~0.1 s a step on one thread)
NEW_TIMED_STEPS = 10
L12_PARSE_THREADS = 8
# float PCM against S16 / 32767: trunc toward zero loses under one step
FLOAT_TOL = 1.001 / 32767
# phase 19: (start s, duration s) of each pool's two joins, and the steps
# served before them
JOINS = ((0.1, 0.2), (0.3, 0.15))
JOIN_SLOTS = (3, B // 2 + 1)
JOIN_LEAD_STEPS = 2
# phase 21: copies of phase 3's streams, and the subset size
FILE_COPIES = 16
FILE_SUBSET = 64
# phase 35: Layer I/II time steps a frame, by layer
L12_S = {1: 12, 2: 36}
# phase 36: the resampler's pair and the block sizes of its steps (Layer
# III, LSF, Layer I frames; fewer than taps - 1 samples)
RESAMPLE_PAIR = (44100, 48000)
RESAMPLE_BLOCKS = (1152, 576, 384, 10, 1152)
# phase 18 and 22's watched Layer I/II features
L12_FEATURES = [("mode", 0), ("mode", 3), ("mode", 1), ("mode", 2),
                ("sfreq", 1), ("sfreq", 2), ("bitrate_index", 6)]
# phase 22: shards of the card in the mesh, and each pool's parse threads
# per native call (a sharded pool makes one call per shard)
SHARDS = 2
SHARDED_PARSE_THREADS = 8
# phase 23: processes on the card, and the seconds they may take
RANKS = 2
RANK_TIMEOUT_S = 300
# phase 24: shards of dryrun_multichip's mesh
DRYRUN_SHARDS = 4
# phases 25-31 run the port's tools (pdmp3_tpu_torch/tools/): the serving
# diff's streams and seed base, the scale simulation's slots, shards and
# steps (BASELINE.json configs[4]), the wire profile's blocked steps,
# pipelined seconds and alternating trials, the multi-process soak's
# ranks, the parse sweep's slots and seconds per thread count, and the
# soak's streams and TorchDSP cadence
DIFF_STREAMS = 512
DIFF_SEED_BASE = 300000
SCALE_SLOTS = 102400
SCALE_SHARDS = 8
SCALE_STEPS = 3
WIRE_STEPS = 8
WIRE_E2E_S = 2.0
WIRE_TRIALS = 2
WIRE_TRIAL_S = 1.5
SOAK_RANKS = 4
PARSE_SLOTS = 8192
PARSE_SECONDS = 1.0
SOAK_STREAMS = 64
SOAK_TORCH_EVERY = 16
# phase 33: pdmp3_tpu_torch.bench.Sizes with bench.py's sizes turned
# down (the sweep is B alone)
BENCH_SIZES = dict(steps=64, repeats=2, e2e_slots=1024, e2e_distinct=16,
                   e2e_trials=1, e2e_seconds=0.5, drain_slots=1024,
                   drain_trials=2, drain_seconds=0.5, at_size_slots=256,
                   at_size_steps=8, host_trials=1, host_seconds=0.3,
                   lsf_e2e_slots=256, lsf_distinct=8)
# phase 33: the bench's keys that hold a rate, a time or a size, each
# finite and positive (with kernel_sweep_rtf's and serving_at_size's)
BENCH_RATE_KEYS = (
    "value", "kernel_rtf", "split_rtf", "exact_rtf", "kernel_exact_rtf",
    "split_exact_rtf", "step_ms", "granules_per_sec",
    "e2e_serving_rtf_sparse_kernel", "e2e_serving_rtf_dense_kernel",
    "e2e_rtf_drain_sync", "e2e_rtf_drain_async",
    "wire_bytes_per_granule_dense", "wire_bytes_per_granule_sparse",
    "lsf_rtf_kernel_22k05", "e2e_lsf_sparse_kernel_rtf_22k05",
    "l12_rtf_layer2_44k1", "native_singlecore_frames_per_sec",
    "host_parse_frames_per_sec_1t", "h2d_gbps")
# wall seconds per phase (phase name -> seconds)
PHASE_SECONDS = {}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# every launch of this process, kept across the phases' resets
LAUNCH_TOTALS = collections.Counter()


def reset_launch_counts() -> None:
    from pdmp3_tpu_torch.ops import launch

    LAUNCH_TOTALS.update(launch.LAUNCHES)
    launch.reset()


def launched() -> dict:
    """The launches since the last reset, by kernel, only those with
    any."""
    from pdmp3_tpu_torch.tools import launches

    return {k: n for k, n in launches().items() if n}


# launches of each MPEG-1 kernel in a pool's one-frame step, which widens
# the pool's coded wire (K10) once
POOL_STEP_LAUNCHES = {"fused_granule": 2, "fused_granule_exact": 2,
                      "fused_granule_float": 2,
                      "fused_granule_float_exact": 2, "frame_fused": 1}


def launch_counts(path: str, kernel: str, pool: bool = False) -> int:
    """The launches of `kernel` since the last reset; every other kernel
    must have launched no time on the path, but K9 on a K7 path: a Layer
    I/II pool (one frame a step) requantizes its coded frames once before
    each K7 launch, so there K9 must have launched as often as K7; and
    K10 on the path of an MPEG-1 pool (`pool`, one frame a step): once a
    step, before the step's POOL_STEP_LAUNCHES of `kernel`."""
    from pdmp3_tpu_torch.tools import launches

    counts = launches()
    beside = {"l12_requant": counts[kernel]} if kernel.startswith(
        "l12_synth") else {}
    per = POOL_STEP_LAUNCHES.get(kernel) if pool else None
    if per:
        check(counts[kernel] % per == 0,
              f"{path}: {counts[kernel]} {kernel} launches, not whole steps")
        beside["l3_expand"] = counts[kernel] // per
    others = {k: n for k, n in counts.items()
              if k != kernel and n != beside.get(k, 0)}
    check(not others, f"{path}: launched {others} beside {kernel}")
    return counts[kernel]


def corpus() -> list[tuple[bytes, dict]]:
    """64 distinct 12-frame streams in bench.py's serving mix (blocks,
    mode, bitrate, sample rate, reservoir), with the joint-stereo
    streams carrying MS (mode_extension 2) or MS + intensity (3) so that
    both stereo paths run."""
    from pdmp3_tpu_torch.testing import mp3gen

    out = []
    i = 0
    while len(out) < N_STREAMS:
        spec = dict(n_frames=FRAMES_PER_STREAM, seed=7000 + i,
                    blocks=["long", "varied", "short", "mixed"][i % 4],
                    mode=[0, 1, 1, 3][i % 4],
                    bitrate_index=[9, 11, 14, 7][(i // 4) % 4],
                    sfreq=i % 3, use_reservoir=i % 5 == 0)
        if spec["mode"] == 1:
            spec["mode_extension"] = 2 if (i // 4) % 2 == 0 else 3
        i += 1
        try:
            out.append((mp3gen.make_stream(**spec), spec))
        except AssertionError:   # the encoder could not fit the budget
            continue
    return out


def lsf_corpus(family: int) -> list[tuple[bytes, dict]]:
    """64 distinct 12-frame streams of one LSF family in the mix of
    tests/test_lsf.py's JAX_MATRIX: long, short, mixed and varied blocks;
    MS, MS + intensity with a short ch1 extent (stereo_extent_ch1), mono
    and plain stereo; sample rates 0-2 of the family (MPEG-2: 22.05 /
    24 / 16 kHz, MPEG-2.5: 11.025 / 12 / 8 kHz); some with the bit
    reservoir; 64 to 128 kbit/s."""
    from pdmp3_tpu_torch.testing import mp3gen

    out = []
    i = 0
    while len(out) < N_STREAMS:
        spec = dict(n_frames=FRAMES_PER_STREAM, seed=8000 + 100 * family + i,
                    family=family,
                    blocks=["long", "varied", "short", "mixed"][i % 4],
                    mode=[1, 1, 3, 0][(i // 4) % 4],
                    bitrate_index=[8, 10, 11, 12][(i // 16) % 4],
                    sfreq=i % 3, use_reservoir=i % 5 == 0)
        if spec["mode"] == 1:
            spec["mode_extension"] = 2 if (i // 4) % 4 == 0 else 3
            if spec["mode_extension"] == 3:
                spec["stereo_extent_ch1"] = 0.4
        i += 1
        try:
            out.append((mp3gen.make_stream(**spec), spec))
        except AssertionError:   # the encoder could not fit the budget
            continue
    return out


@functools.lru_cache(maxsize=None)
def l12_corpus(layer: int) -> list[tuple[bytes, dict]]:
    """64 distinct 12-frame Layer I or II streams: stereo, joint stereo,
    dual channel and mono, four bitrates of the layer, the three MPEG-1
    sample rates."""
    from pdmp3_tpu_torch.testing import mp3gen

    out = []
    i = 0
    while len(out) < N_STREAMS:
        spec = dict(layer=layer, n_frames=FRAMES_PER_STREAM,
                    seed=9000 + 100 * layer + i, mode=[0, 3, 1, 2][i % 4],
                    bitrate_index=[6, 8, 10, 12][(i // 4) % 4],
                    sfreq=i % 3)
        if spec["mode"] == 1:
            spec["mode_extension"] = (i // 4) % 4
        i += 1
        try:
            out.append((mp3gen.make_l12_stream(**spec), spec))
        except (AssertionError, ValueError):   # no such allocation table
            continue
    return out


def corpus_44k() -> list[tuple[bytes, dict]]:
    """Phase 20's rate-homogeneous corpus: 64 distinct 12-frame MPEG-1
    streams at 44.1 kHz in corpus()'s mix of blocks, modes and
    bitrates."""
    from pdmp3_tpu_torch.testing import mp3gen

    out = []
    i = 0
    while len(out) < N_STREAMS:
        spec = dict(n_frames=FRAMES_PER_STREAM, seed=9500 + i,
                    blocks=["long", "varied", "short", "mixed"][i % 4],
                    mode=[0, 1, 1, 3][i % 4],
                    bitrate_index=[9, 11, 14, 7][(i // 4) % 4], sfreq=0,
                    use_reservoir=i % 5 == 0)
        if spec["mode"] == 1:
            spec["mode_extension"] = 2
        i += 1
        try:
            out.append((mp3gen.make_stream(**spec), spec))
        except AssertionError:   # the encoder could not fit the budget
            continue
    return out


def granule_bound(n_slots: int, n_active: int, lsf: bool = False,
                  float_pcm: bool = False) -> dict:
    """The least time one fused granule step (K1, K2 or K3; with
    float_pcm their instances 9-12) could take for n_slots slots,
    n_active of them active: the larger of its bytes (every input read
    once, every output written once; idle slots read their flag and
    write silent PCM only) over the memory rate, and its f32 operations
    over the f32 rate.  Per active slot: ix 2,304 B, scalefactors and
    meta 372 B (+128 B LSF sidecar), store 4,608 B and v 7,680 B each
    read and written, prev_lines 12 B read and written; PCM 2,304 B per
    slot (float PCM 4,608 B).  Operations per active slot and channel: the
    36-point IMDCT of 32 subbands (36 x 35 each), its window and
    overlap-add, frequency inversion, the 18 x 64 matrixing dots of 32
    terms (63 each), the 16-tap FIR of 576 samples (32 each), the
    antialias butterflies (8 x 31 x 6), requantize (3 per line), stereo
    (4 per line) and the x32767 quantize."""
    per_active = granule_wire_bytes(lsf) + STATE_BYTES
    nbytes = (n_slots * (4 + 2304 * (2 if float_pcm else 1))
              + n_active * per_active)
    return bound(nbytes, n_active * 2 * GRANULE_OPS_PER_CH)


# store, v and prev_lines of one slot, read and written
STATE_BYTES = 2 * (4608 + 7680 + 12)
# f32 operations of one granule step per active slot and channel
GRANULE_OPS_PER_CH = (32 * 36 * 35 + 32 * 36 + 576 + 576 + 18 * 64 * 63
                      + 576 * 32 + 8 * 31 * 6 + 576 * 3 + 576 * 4 + 576)


def granule_wire_bytes(lsf: bool = False) -> int:
    """Wire bytes one active slot reads per granule: ix, scalefactors
    and meta, and the LSF sidecar."""
    return 2304 + 2 * 22 * 2 + 2 * 39 * 2 + 32 * 4 + (128 if lsf else 0)


def frame_bound(active: torch.Tensor, lsf: bool = False) -> dict:
    """K5's bound for one launch over ng granules (active int32 [ng,
    B]), as granule_bound, but store, v and prev_lines cross the granules
    on chip: a slot active in any granule reads and writes them once per
    launch.  Per granule and slot the active flag and the PCM; per active
    granule-slot the wire and the operations.  For ng = 2 and every slot
    active, 34.6 KB per slot where two granule steps move 59.2 KB."""
    ng, n_slots = active.shape
    granules = int((active != 0).sum())
    slots = int((active != 0).any(0).sum())
    nbytes = (ng * n_slots * (4 + 2304) + granules * granule_wire_bytes(lsf)
              + slots * STATE_BYTES)
    return bound(nbytes, granules * 2 * GRANULE_OPS_PER_CH)


def back_half_bound(n_slots: int, n_active: int) -> dict:
    """K4's bound, as granule_bound: xa 4,608 B, bt_eff 256 B and the
    active flag in, out 4,608 B and prev3 12 B per slot; store and v
    read and written per active slot; the back half's operations."""
    nbytes = (n_slots * (4608 + 256 + 4 + 4608 + 12)
              + n_active * 2 * (4608 + 7680))
    per_ch = (32 * 36 * 35 + 32 * 36 + 576 + 576 + 18 * 64 * 63
              + 576 * 32 + 576)
    return bound(nbytes, n_active * 2 * per_ch)


def sweep_bound(n: int, constructions: int) -> dict:
    """K6's bound for one chunk of n inputs per construction: 4 B written
    per input (the inputs are built on the card), and at most 6 f64
    operations per input (uq_f64's trunc, divide, floor, multiply,
    subtract and add)."""
    return bound(4 * n * constructions, 0, f64_ops=6 * n * constructions)


def bound(nbytes: float, ops: float, f64_ops: float = 0.0) -> dict:
    """{bound_ms, bound_by} from bytes and f32 / f64 operations at the
    card's peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_timing(res: dict, fn) -> None:
    """A kernel's times over TIMED_LAUNCHES calls of fn
    (pdmp3_tpu_torch/timing.py), into res: kernel_ms, its device time per
    launch (CUDA events around replays of a CUDA graph of the calls);
    kernel_burst_ms, CUDA events around a burst of back-to-back calls
    over the calls, median of bursts; and kernel_per_call_ms, events
    around one call, its Python launcher included."""
    from pdmp3_tpu_torch import timing as T

    res["kernel_ms"] = T.graph_ms(fn, TIMED_LAUNCHES)
    res["kernel_burst_ms"] = T.burst_ms(fn, TIMED_LAUNCHES)
    res["kernel_per_call_ms"] = T.per_call_ms(fn, TIMED_LAUNCHES)


def plain_ms(fn) -> float:
    """A plain version's (or a route's) device time per call: CUDA events
    around bursts of PLAIN_CALLS calls, the median of PLAIN_BURSTS."""
    from pdmp3_tpu_torch import timing as T

    return T.burst_ms(fn, PLAIN_CALLS, PLAIN_BURSTS, warmup=1)


def per_call_ms(fn, n: int) -> float:
    """Median over n calls of events around one call of fn (host work
    included: a route's step as its caller sees it)."""
    from pdmp3_tpu_torch import timing as T

    return T.per_call_ms(fn, n)


def clone_state(s):
    from pdmp3_tpu_torch.models.decoder import DecoderState
    return DecoderState(s.store.clone(), s.v_blocks.clone(),
                        s.prev_lines.clone())


def slot_state(s, n: int):
    """The first n slots of a state (views)."""
    from pdmp3_tpu_torch.models.decoder import DecoderState
    return DecoderState(s.store[:n], s.v_blocks[:n], s.prev_lines[:n])


def pcm_error(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), float((d != 0).float().mean())


def parsed_frame(streams: list[bytes], dev, family: int = 0) -> dict:
    """One natively parsed frame of wire for B slots on the card (the
    INACTIVE slots idle) and a random starting state.  Sections keep a
    leading granule axis (one granule for an LSF family, whose frame
    also carries the is_pos sidecar)."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.models.decoder import (DecoderState, wire_sections,
                                                wire_sections_lsf)
    from pdmp3_tpu_torch.testing import l3wire

    dec = StreamDecoder(B, family=family, device=dev)
    LoopFeeder(dec, streams).step()
    check(dec.parse_step() == B, "not every slot parsed a frame")
    # an MPEG-1 pool's coded wire made dense by the plain widening
    wire = (torch.from_numpy(dec.wire.copy()) if family
            else l3wire.pool_dense_wire(dec)).to(dev)
    del dec
    if family:
        w = wire_sections_lsf(wire, B)   # [1, B, ...]: one frame
        w["is_pos"] = w["is_pos"][0]
    else:
        w = wire_sections(wire, B)
    active = w["active"].to(torch.int32)
    active[list(INACTIVE)] = 0
    rng = np.random.default_rng(0)
    st0 = DecoderState(*(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
        for shape in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))
    return {"ix": w["ix"], "scf_l": w["scf_l"], "scf_s": w["scf_s"],
            "meta": w["meta"].to(torch.int32), "active": active,
            "is_pos": w.get("is_pos"), "st0": st0}


def granule_args(fr: dict, gr: int) -> tuple:
    return (fr["ix"][gr], fr["scf_l"][gr], fr["scf_s"][gr],
            fr["meta"][gr].contiguous(), fr["active"], gr)


def granule_kw(fr: dict) -> dict:
    """The LSF sidecar of an LSF frame as a keyword of the granule step."""
    return {} if fr.get("is_pos") is None else {"is_pos": fr["is_pos"]}


def compare_steps(fr: dict, step_k, step_r, phase: str, grs=(0, 1),
                  st0=None) -> dict:
    """Run the granules grs with a kernel step and its plain version from
    the same state; require PCM and state bitwise equal and the idle
    slots silent and frozen."""
    st0 = fr["st0"] if st0 is None else st0

    def run(step, state):
        outs = []
        for gr in grs:
            pcm, state = step(*granule_args(fr, gr), state, **granule_kw(fr))
            outs.append(pcm)
        return torch.cat(outs, 1), state

    pk, sk = run(step_k, clone_state(st0))
    pr, sr = run(step_r, clone_state(st0))
    return bitwise_report(pk, sk, pr, sr, st0, phase)


def bitwise_report(pk, sk, pr, sr, st0, phase: str) -> dict:
    """A kernel's PCM and state (pk, sk) against its plain version's (pr,
    sr), both run from st0: require them bitwise equal, the INACTIVE
    slots (those below the batch's size) silent and frozen, and slot 0
    audible.  Float PCM is compared as bits; its max_abs_err is
    reported."""
    torch.cuda.synchronize()
    if pk.dtype == torch.float32:
        lsb, frac = 0, 0.0
        res = {"tolerance": "bitwise (float PCM bits, store, v, "
                            "prev_lines)",
               "pcm_max_abs_err": float((pk - pr).abs().max()),
               "pcm_bitwise_equal": bool(torch.equal(
                   pk.view(torch.int32), pr.view(torch.int32)))}
    else:
        lsb, frac = pcm_error(pk, pr)
        res = {"tolerance": "bitwise (PCM, store, v, prev_lines); "
                            f"reported: PCM <= {MAX_LSB} LSB on < "
                            f"{MAX_FRAC:.0%} of samples, store/v/prev <= "
                            f"{STATE_RTOL} x max(1, max|plain|)",
               "pcm_max_lsb": lsb, "pcm_frac_differing": frac,
               "pcm_bitwise_equal": bool(torch.equal(pk, pr))}
    for name in ("store", "v_blocks", "prev_lines"):
        a, b = getattr(sk, name), getattr(sr, name)
        res[f"{name}_max_abs_err"] = float((a - b).abs().max())
        res[f"{name}_bitwise_equal"] = bool(
            torch.equal(a.view(torch.int32), b.view(torch.int32)))
    # the kernel rounds where the plain version rounds and sums in its
    # order (no FMA contraction), so any difference is a fault
    check(lsb <= MAX_LSB and frac < MAX_FRAC,
          f"{phase}: kernel vs plain PCM {lsb} LSB on {frac:.4%}")
    for name in ("pcm", "store", "v_blocks", "prev_lines"):
        check(res[f"{name}_bitwise_equal"],
              f"{phase}: {name} not bitwise equal to the plain version "
              f"({json.dumps(res)})")
    for s in (s for s in INACTIVE if s < pk.shape[0]):
        check(not bool(pk[s].any()), f"{phase}: idle slot {s} has PCM")
        for name in ("store", "v_blocks", "prev_lines"):
            check(torch.equal(getattr(sk, name)[s].view(torch.int32),
                              getattr(st0, name)[s].view(torch.int32)),
                  f"{phase}: idle slot {s} {name} changed")
    check(bool(pk[0].any()), f"{phase}: active slot 0 is silent")
    return res


def ragged_frame(fr: dict, n: int) -> dict:
    """The first n slots of a parsed frame, state copied; an LSF frame's
    is_pos sidecar copied to an address 4 bytes past a 16-byte boundary,
    where the packed LSF wire puts it when its B % 4 != 0."""
    ip = fr["is_pos"]
    if ip is not None:
        buf = torch.empty(n * 64 + 8, dtype=torch.int16, device=ip.device)
        off = (4 - buf.data_ptr() % 16) % 16 // 2
        ip = buf[off:off + n * 64].view(n, 64)
        ip.copy_(fr["is_pos"][:n])
        check(ip.data_ptr() % 16 == 4, "is_pos not 4 past 16-byte")
    return dict({k: fr[k][:, :n] for k in ("ix", "scf_l", "scf_s", "meta")},
                active=fr["active"][:n], is_pos=ip,
                st0=clone_state(slot_state(fr["st0"], n)))


def phase_kernel(fr: dict, exact: bool, family: int = 0) -> dict:
    """The fused kernel (family 0: K1, or K2 when exact; LSF: K3) vs its
    plain version on one natively parsed frame and on its first 2 x grid
    + 3 slots, a ragged B (grid: the instance's persistent grid, printed
    with its launch geometry); both timed per granule step."""
    from pdmp3_tpu_torch.ops import fused_step as FS
    from pdmp3_tpu_torch.ops import launch as LA

    phase = ("phase 10" if family else "phase 5" if exact else "phase 2")
    step_k = functools.partial(FS.fused_granule_step, exact=exact,
                               family=family)
    step_r = functools.partial(FS.fused_granule_step_ref, exact=exact,
                               family=family)
    grs = (0,) if family else (0, 1)
    res = compare_steps(fr, step_k, step_r, phase, grs=grs)
    launch = LA.granule_launch_info(fr["ix"].device, exact, family)
    n = 2 * launch["grid"] + 3
    res["launch"] = launch
    rfr = ragged_frame(fr, n)
    res["ragged"] = dict(batch_slots=n, **compare_steps(
        rfr, step_k, step_r, f"{phase} ragged B={n}", grs=grs))
    if family:
        res["ragged"]["is_pos_address_mod_16"] = rfr["is_pos"].data_ptr() % 16
    if exact and not family:
        res["band12_subnormal"] = phase_band12_subnormal(fr, step_k,
                                                         step_r)
    # granule steps on state copies made before the timed window
    sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
    args, kw = granule_args(fr, 0), granule_kw(fr)
    kernel_timing(res, lambda: step_k(*args, sk, **kw))
    res["plain_ms"] = plain_ms(lambda: step_r(*args, sr, **kw))
    res.update(granule_bound(B, int((fr["active"] != 0).sum()),
                             lsf=family != 0))
    return res


def phase_float_kernel(fr: dict, exact: bool, family: int = 0) -> dict:
    """Phase 34: K1, K2 or K3's float instance (9-12: fused_granule_step(
    float_pcm=True)) against its plain version (fused_granule_step_ref(
    float_pcm=True)) on a parsed frame at B (MPEG-1: both granules), from
    the random state and from one whose FIFO rows drive slots 0-4's sums
    to NaN, +-inf and past the rails; at the ragged B = 2 x grid + 3 with
    idle slots at the seams of its slot ring; MPEG-1 also on phase 5's
    subnormal band-12 carry.  Bitwise (PCM bits and state), timed per
    granule step, with its launch geometry and bound."""
    from pdmp3_tpu_torch.ops import fused_step as FS
    from pdmp3_tpu_torch.ops import launch as LA

    phase = f"phase 34 family {family} exact={exact}"
    step_k = functools.partial(FS.fused_granule_step, exact=exact,
                               family=family, float_pcm=True)
    step_r = functools.partial(FS.fused_granule_step_ref, exact=exact,
                               family=family, float_pcm=True)
    grs = (0,) if family else (0, 1)
    res = compare_steps(fr, step_k, step_r, phase, grs=grs)
    hostile = clone_state(fr["st0"])
    for s, x in enumerate((float("nan"), float("inf"), float("-inf"), 3e38,
                           -3e38)):
        hostile.v_blocks[s, s % 2, 5:9, 3:40] = x
    res["nan_inf_state"] = compare_steps(fr, step_k, step_r,
                                         f"{phase} NaN/inf state", grs=grs,
                                         st0=hostile)
    launch = LA.granule_launch_info(fr["ix"].device, exact, family,
                                    float_pcm=True)
    grid = launch["grid"]
    n = 2 * grid + 3
    rfr = ragged_frame(fr, n)
    seams = [grid - 1, grid, 2 * grid - 1, 2 * grid, n - 1]
    rfr["active"] = rfr["active"].clone()
    rfr["active"][seams] = 0
    res["ragged"] = dict(batch_slots=n, idle_slots=seams, **compare_steps(
        rfr, step_k, step_r, f"{phase} ragged B={n}", grs=grs))
    if not family:
        res["band12_subnormal"] = phase_band12_subnormal(fr, step_k, step_r,
                                                         phase)
    res["launch"] = launch
    sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
    args, kw = granule_args(fr, 0), granule_kw(fr)
    kernel_timing(res, lambda: step_k(*args, sk, **kw))
    res["plain_ms"] = plain_ms(lambda: step_r(*args, sr, **kw))
    res.update(granule_bound(B, int((fr["active"] != 0).sum()),
                             lsf=family != 0, float_pcm=True))
    return res


def phase_band12_subnormal(fr: dict, step_k, step_r,
                           phase: str = "phase 5") -> dict:
    """Granule 1 with prev_lines holding the subnormal bit patterns
    SUBNORMAL_BITS and every ch1 line coded, so the short band-12 lines
    of ch1 take the true gain GAIN_QUARTER_TRUE[q], subnormal for q in
    504..599: the exact kernel vs its plain version, bitwise."""
    from pdmp3_tpu_torch.ops import dsp as D

    lo, hi = SUBNORMAL_BITS
    bits = lo + torch.arange(B * 3, device=fr["ix"].device) % (hi - lo)
    st0 = clone_state(fr["st0"])
    st0.prev_lines.copy_(bits.to(torch.int32).view(torch.float32)
                         .reshape(B, 3))
    ix = fr["ix"].clone()
    ix[1, :, 1] = (torch.arange(576, device=ix.device) % 7 - 3) \
        .to(torch.int16)
    res = compare_steps(dict(fr, ix=ix), step_k, step_r,
                        f"{phase} band-12 subnormal", grs=(1,), st0=st0)
    f = D.fields(fr["meta"][1])
    q = (2 << f.scalefac_scale[:, 1:2].long()) * bits.reshape(B, 3)
    short1 = f.layout[:, 1] % 3 != 0
    hit = short1 & (fr["active"] != 0) & ((q >= 504) & (q < 600)).any(1)
    res["slots_with_subnormal_band12_gain"] = int(hit.sum())
    check(res["slots_with_subnormal_band12_gain"] > 0,
          f"{phase}: no slot reached a subnormal band-12 gain")
    return res


def frame_operands(fr: dict, family: int = 0) -> tuple:
    """K5's operands and parities from a parsed frame: MPEG-1's two
    granules as the wire holds them (parities (0, 1)), an LSF frame's one
    granule taken twice (parities (0, 0)); active [2, B] with the
    INACTIVE slots idle in both granules and IDLE_SECOND in the second."""
    if family:
        ops = [torch.cat([fr[k], fr[k]]) for k in ("ix", "scf_l", "scf_s",
                                                    "meta")]
        lsf = dict(family=family, is_pos=torch.stack([fr["is_pos"]] * 2))
        parities = (0, 0)
    else:
        ops = [fr[k].contiguous() for k in ("ix", "scf_l", "scf_s",
                                              "meta")]
        lsf, parities = {}, (0, 1)
    active = torch.stack([fr["active"]] * 2)
    active[1, IDLE_SECOND] = 0
    return ops + [active], parities, lsf


def compare_frame(ops, parities, lsf, st0, phase: str) -> dict:
    """K5 against frame_step_ref from st0: bitwise, idle slots frozen; the
    slot idle in the second granule silent there only."""
    from pdmp3_tpu_torch.ops import frame_step as FR

    pk, sk = FR.frame_step(*ops, parities, clone_state(st0), **lsf)
    pr, sr = FR.frame_step_ref(*ops, parities, clone_state(st0), **lsf)
    res = bitwise_report(pk, sk, pr, sr, st0, phase)
    check(bool(pk[IDLE_SECOND, :576].any())
          and not bool(pk[IDLE_SECOND, 576:].any()),
          f"{phase}: slot {IDLE_SECOND} idle in granule 1 only")
    return res


def phase_frame_kernel(fr: dict, family: int = 0) -> dict:
    """Phase 14: K5 vs its plain version on one parsed frame and on its
    first 2 x grid + 3 slots (K5's grid, with its launch geometry),
    bitwise (MPEG-1 also on the directed band-12 fixture), both timed
    per launch; for MPEG-1 also two K1 launches on the same granules,
    interleaved with K5's in one loop."""
    from pdmp3_tpu_torch.ops import frame_step as FR
    from pdmp3_tpu_torch.ops import fused_step as FS
    from pdmp3_tpu_torch.ops import launch as LA

    phase = f"phase 14 family {family}"
    ops, parities, lsf = frame_operands(fr, family)
    res = compare_frame(ops, parities, lsf, fr["st0"], phase)
    launch = LA.granule_launch_info(fr["ix"].device, family=family,
                                    frame=True)
    n = 2 * launch["grid"] + 3
    rfr = ragged_frame(fr, n)
    rops, _, rlsf = frame_operands(rfr, family)
    res["launch"] = launch
    res["ragged"] = dict(batch_slots=n, **compare_frame(
        rops, parities, rlsf, rfr["st0"], f"{phase} ragged B={n}"))
    if not family:
        res["band12_carry"] = phase_band12_carry(ops, fr["st0"])
    sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
    kernel_timing(res, lambda: FR.frame_step(*ops, parities, sk, **lsf))
    res["plain_ms"] = plain_ms(
        lambda: FR.frame_step_ref(*ops, parities, sr, **lsf))
    res.update(frame_bound(ops[4], lsf=family != 0))
    if family:
        return res
    s5, s1 = clone_state(fr["st0"]), clone_state(fr["st0"])

    def two_k1():
        for g in (0, 1):
            FS.fused_granule_step(*(o[g] for o in ops), g, s1)
    k5, k1 = [], []
    for _ in range(TIMED_LAUNCHES):
        k5.append(per_call_ms(lambda: FR.frame_step(*ops, parities, s5),
                              1))
        k1.append(per_call_ms(two_k1, 1))
    res["ab_interleaved"] = {
        "launches_each": TIMED_LAUNCHES,
        "k5_ms": float(np.median(k5)), "two_k1_ms": float(np.median(k1)),
        "k5_over_two_k1": float(np.median(k5) / np.median(k1)),
        "two_k1_bound_ms": 2 * granule_bound(
            B, int((ops[4][0] != 0).sum()))["bound_ms"]}
    # K5 at ng = 1: granule 0 alone, K1's work with the slot's state in a
    # state set instead of the stage
    ops1 = [o[0:1] for o in ops]
    s5, s1 = clone_state(fr["st0"]), clone_state(fr["st0"])
    k5, k1 = [], []
    for _ in range(TIMED_LAUNCHES):
        k5.append(per_call_ms(lambda: FR.frame_step(*ops1, (0,), s5), 1))
        k1.append(per_call_ms(
            lambda: FS.fused_granule_step(*(o[0] for o in ops), 0, s1), 1))
    res["ng1_ab_interleaved"] = {
        "launches_each": TIMED_LAUNCHES,
        "k5_ng1_ms": float(np.median(k5)), "k1_ms": float(np.median(k1)),
        "k1_over_k5_ng1": float(np.median(k1) / np.median(k5))}
    return res


def phase_band12_carry(ops: list, st0) -> dict:
    """The directed band-12 fixture: granule 0's ch0 lines of subbands 0
    and 1 zeroed, so its x_time[0:3] of (ch0, subband 0) is the starting
    store, seeded with the small subnormal bit patterns CARRY_BITS; every
    ch1 line of granule 1 coded.  K5 latches the carry in granule 0 and
    reads it as ch1's band-12 scalefactors in granule 1 (small enough to
    give audible gains on short blocks): bitwise vs the plain chain, and
    prev_lines after the frame holds the seeded bits."""
    from pdmp3_tpu_torch.ops import dsp as D

    lo, hi = CARRY_BITS
    dev = ops[0].device
    bits = (lo + torch.arange(B * 3, device=dev) % (hi - lo)).to(torch.int32)
    st = clone_state(st0)
    st.store[:, 0, 0, 0:3] = bits.view(torch.float32).reshape(B, 3)
    ix = ops[0].clone()
    ix[0, :, :, 0:36] = 0
    ix[1, :, 1] = (torch.arange(576, device=dev) % 7 - 3).to(torch.int16)
    fops = [ix] + ops[1:]
    res = compare_frame(fops, (0, 1), {}, st, "phase 14 band-12 carry")
    from pdmp3_tpu_torch.ops import frame_step as FR
    _, sk = FR.frame_step(*fops, (0, 1), clone_state(st))
    both = (ops[4] != 0).all(0)
    latched = sk.prev_lines.view(torch.int32)[both]
    check(torch.equal(latched, bits.reshape(B, 3)[both]),
          "phase 14: the latched carry is not the seeded bits")
    f = D.fields(ops[3][1])
    hit = (f.layout[:, 1] % 3 != 0) & both
    res["slots_reading_subnormal_carry_on_short_ch1"] = int(hit.sum())
    check(res["slots_reading_subnormal_carry_on_short_ch1"] > 0,
          "phase 14: no short ch1 granule read the carry")
    return res


def compare_back_half(xa, st0, bt, active, exact: bool, what: str,
                      raw: bool = False) -> dict:
    """K4 and its plain version from copies of st0 on the same operands:
    out, prev3, store and v_blocks required bitwise equal."""
    from pdmp3_tpu_torch.ops import back_half as BH

    sk, sr = clone_state(st0), clone_state(st0)
    ok, pk = BH.back_half_step(xa, sk, bt, active, exact, raw)
    orf, pr = BH.back_half_step_ref(xa, sr, bt, active, exact, raw)
    torch.cuda.synchronize()
    pairs = {"out": (ok, orf), "prev3": (pk, pr),
             "store": (sk.store, sr.store),
             "v_blocks": (sk.v_blocks, sr.v_blocks)}
    r = {"max_abs_err": max(float((a - b).abs().max())
                            for a, b in pairs.values())}
    for name, (a, b) in pairs.items():
        r[f"{name}_bitwise_equal"] = bool(
            torch.equal(a.view(torch.int32), b.view(torch.int32)))
        check(r[f"{name}_bitwise_equal"],
              f"{what} {name} differs from the plain version")
    return r


def phase_back_half(fr: dict) -> dict:
    """K4 vs its plain version, exact and fast, on the post-antialias
    spectra of granule 0 at B and at one slot (slot 0, the shape at which
    the per-stream route, TorchDSP, launches it), bitwise, both timed,
    with each instance's launch geometry; one step of the batched split
    route (decode_granules: the stage-op front half, K4, the pack) timed
    at B in both modes; then the fused exact route (K2) vs the split one,
    bitwise."""
    from pdmp3_tpu_torch.models.decoder import GranuleBatch, decode_granules
    from pdmp3_tpu_torch.ops import back_half as BH
    from pdmp3_tpu_torch.ops import dsp as D
    from pdmp3_tpu_torch.ops import fused_step as FS
    from pdmp3_tpu_torch.ops import launch as LA

    args = granule_args(fr, 0)
    f = D.fields(args[3])
    bt = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    act = fr["active"]
    res = {}
    for exact in (True, False):
        mode = "exact" if exact else "fast"
        xa = D.front_half(*args[:4], 0, fr["st0"].prev_lines, exact)
        r = compare_back_half(xa, fr["st0"], bt, act, exact,
                              f"phase 7: K4 {mode}")
        one = (xa[:1], slot_state(fr["st0"], 1), bt[:1], act[:1])
        r["one_slot"] = compare_back_half(*one, exact,
                                          f"phase 7: K4 {mode} one slot")
        # state copies made before the timed window
        sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
        kernel_timing(r, functools.partial(BH.back_half_step, xa, sk, bt,
                                           act, exact))
        r["plain_ms"] = plain_ms(
            lambda: BH.back_half_step_ref(xa, sr, bt, act, exact))
        s1, r1 = clone_state(one[1]), clone_state(one[1])
        kernel_timing(r["one_slot"], functools.partial(
            BH.back_half_step, one[0], s1, one[2], one[3], exact))
        r["one_slot"]["plain_ms"] = plain_ms(
            lambda: BH.back_half_step_ref(one[0], r1, one[2], one[3], exact))
        r["launch"] = LA.granule_launch_info(xa.device, exact,
                                             back_half=True)
        batch = GranuleBatch(*args)
        st = clone_state(fr["st0"])
        r["split_step_ms"] = plain_ms(
            lambda: decode_granules(batch, st, exact))
        res[mode] = r
    res.update(back_half_bound(B, int((act != 0).sum())))
    res["one_slot_bound"] = back_half_bound(1, 1)
    res["fused_vs_split"] = compare_steps(
        fr, functools.partial(FS.fused_granule_step, exact=True),
        functools.partial(BH.split_granule_step, exact=True),
        "phase 7 fused vs split")
    return res


def phase_k4_raw(fr: dict, exact: bool = False, family: int = 0,
                 phase: str = "phase 17") -> dict:
    """K4 with raw sums (instance 8 fast, 7 exact) against its plain
    version (back_half_step_ref(raw=True)) on granule 0's post-antialias
    spectra of a parsed frame (an LSF frame's through the family's front
    half: LSF gains, the intensity sidecar, full-spectrum MS) at B, at
    one slot and at the ragged B = 2 x grid + 3 with idle slots at the
    seams of its slot ring (grid - 1, grid, 2 grid - 1, 2 grid, the
    last), bitwise; timed at B and at one slot; its launch geometry.
    Phase 17's kernel part (MPEG-1, fast) and phase 32's."""
    from pdmp3_tpu_torch.ops import back_half as BH
    from pdmp3_tpu_torch.ops import dsp as D
    from pdmp3_tpu_torch.ops import launch as LA

    args = granule_args(fr, 0)
    f = D.fields(args[3])
    bt = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    act = fr["active"]
    xa = D.front_half(*args[:4], 0, fr["st0"].prev_lines, exact, True,
                      family, fr["is_pos"])
    what = f"{phase}: K4 " + ("exact" if exact else "fast raw sums")
    res = compare_back_half(xa, fr["st0"], bt, act, exact, what, raw=True)
    one = (xa[:1], slot_state(fr["st0"], 1), bt[:1], act[:1])
    res["one_slot"] = compare_back_half(*one, exact, what + " one slot",
                                        raw=True)
    launch = LA.granule_launch_info(xa.device, exact, back_half=True,
                                    raw=True)
    grid = launch["grid"]
    n = 2 * grid + 3
    ract = act[:n].clone()
    seams = [grid - 1, grid, 2 * grid - 1, 2 * grid, n - 1]
    ract[seams] = 0
    res["ragged"] = dict(batch_slots=n, idle_slots=seams, **compare_back_half(
        xa[:n], clone_state(slot_state(fr["st0"], n)), bt[:n], ract, exact,
        f"{what} ragged B={n}", raw=True))
    res["launch"] = launch
    sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
    kernel_timing(res, functools.partial(BH.back_half_step, xa, sk, bt, act,
                                         exact, True))
    res["plain_ms"] = plain_ms(
        lambda: BH.back_half_step_ref(xa, sr, bt, act, exact, True))
    s1, r1 = clone_state(one[1]), clone_state(one[1])
    kernel_timing(res["one_slot"], functools.partial(
        BH.back_half_step, one[0], s1, one[2], one[3], exact, True))
    res["one_slot"]["plain_ms"] = plain_ms(
        lambda: BH.back_half_step_ref(one[0], r1, one[2], one[3], exact,
                                      True))
    res.update(back_half_bound(B, int((act != 0).sum())))
    res["one_slot_bound"] = back_half_bound(1, 1)
    return res


def phase_api(dev, lsf: bool = False) -> dict:
    """decode_file through TorchDSP on the card (MPEG-1 streams, or with
    lsf the LSF ones): exact byte-equal to the native decoder, fast
    within the fast contract; K4 launched in both."""
    from pdmp3_tpu_torch import TorchDSP
    from pdmp3_tpu_torch.api import decode_file
    from pdmp3_tpu_torch.host import PROFILE_LSF, native_decode_file
    from pdmp3_tpu_torch.testing import mp3gen

    phase = "phase 12" if lsf else "phase 8"
    if lsf:
        streams = {name: mp3gen.make_stream(n_frames=8, seed=31,
                                            bitrate_index=11, **spec)
                   for name, spec in LSF_API_CONFIGS.items()}
    else:
        streams = {name: mp3gen.make_stream(n_frames=8, seed=2, **spec)
                   for name, spec in API_CONFIGS.items()}
    profile = PROFILE_LSF if lsf else 0
    res = {"streams": len(streams)}
    reset_launch_counts()
    for exact in (True, False):
        mode = "exact" if exact else "fast"
        n0 = launch_counts(phase, "back_half")
        t0 = time.perf_counter()
        worst = []
        for name, data in streams.items():
            got = decode_file(data, lsf=lsf,
                              dsp=TorchDSP(exact=exact, device=dev))
            want = native_decode_file(data, profile=profile)
            check(len(want) > 0 and len(got) == len(want),
                  f"{phase}: {name} {mode}: {len(got)} vs {len(want)} B")
            if exact:
                check(got == want, f"{phase}: {name} exact differs from "
                                   "the native decoder")
            lsb, frac = pcm_error(
                torch.from_numpy(np.frombuffer(got, "<i2").copy()),
                torch.from_numpy(np.frombuffer(want, "<i2").copy()))
            check(lsb <= MAX_LSB and frac < MAX_FRAC,
                  f"{phase}: {name} {mode} {lsb} LSB on {frac:.4%}")
            worst.append((lsb, frac))
        res[f"{mode}_seconds"] = time.perf_counter() - t0
        res[f"{mode}_k4_launches"] = launch_counts(phase,
                                                   "back_half") - n0
        res[f"{mode}_max_lsb"] = max(w[0] for w in worst)
        res[f"{mode}_max_frac_differing"] = max(w[1] for w in worst)
        check(res[f"{mode}_k4_launches"] > 0,
              f"{phase}: {mode} decode launched no K4")
    res["k4_launches"] = launch_counts(phase, "back_half")
    return res


def phase_sweep(dev) -> dict:
    """K6: the three rounding points over all 2^32 inputs, all three from
    one launch per 2^24-input chunk, against the plain f64 functions;
    then one chunk's times: the launch and the plain functions."""
    from pdmp3_tpu_torch.ops import rounding as R

    reset_launch_counts()
    res = R.sweep(device=dev)
    res["launches"] = launch_counts("phase 9", "rounding_sweep")
    check(res["launches"] == 256, f"phase 9: {res['launches']} sweep "
                                  "launches for 256 chunks")
    check(res["mismatching_chunks"] == [] and res["chunks_swept"] == 256
          and res["mismatching_inputs"] == 0, f"phase 9: {json.dumps(res)}")
    n = 1 << 24
    x = R.chunk_inputs(n, n, dev)
    res["chunk_inputs"] = n
    kernel_timing(res, lambda: R.rounding_sweep_all(n, n, dev))
    res["plain_ms_by_construction"] = {
        name: plain_ms(functools.partial(R.PLAIN[name], x))
        for name in R.CONSTRUCTIONS}
    res["plain_ms"] = sum(res["plain_ms_by_construction"].values())
    return res


def frame_fused_route(on: bool) -> None:
    """Set the frame-fused opt-in (models.decoder._FRAME_FUSED)."""
    from pdmp3_tpu_torch.models import decoder as M
    M._FRAME_FUSED = on


def phase_main_path(streams: list[bytes], dev, watch: list[int],
                    exact: bool = False, family: int = 0,
                    rates: list[int] | None = None,
                    frame_fused: bool = False, float_pcm: bool = False,
                    timed: int = TIMED_STEPS) -> dict:
    """StreamDecoder serving at B slots: MPEG-1 fast (K1) or exact (K2),
    or an LSF pool of `family` (K3), or with frame_fused MPEG-1 fast with
    the frame-fused opt-in set (K5), or with float_pcm MPEG-1 float PCM
    (K1 / K2's float instances 9 / 10, every slot of every step held
    bitwise against decode_granules(float_pcm=True) on the same wire:
    the stage ops and K4, instance 8 fast, 7 exact), over `timed` timed
    steps; returns timings, with an exact_ prefix when exact, lsf{family}_
    for an LSF pool, ff_ when frame fused and float_ for float PCM, and
    the PCM of the watched slots.  rates: each source stream's sample
    rate (the LSF realtime factor's basis)."""
    frame_fused_route(frame_fused)
    try:
        return _main_path(streams, dev, watch, exact, family, rates,
                          frame_fused, float_pcm, timed)
    finally:
        frame_fused_route(False)


def _main_path(streams, dev, watch, exact, family, rates, frame_fused,
               float_pcm, timed):
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder

    path = (f"main path (family={family}, exact={exact}, "
            f"frame_fused={frame_fused}, float_pcm={float_pcm})")
    kernel = ("frame_fused" if frame_fused else "fused_granule"
              + ("_lsf" if family else "") + ("_float" if float_pcm else "")
              + ("_exact" if exact else ""))
    ngr = 1 if family else 2
    per_frame = 1 if frame_fused else ngr
    dec = StreamDecoder(B, exact=exact, family=family, float_pcm=float_pcm,
                        device=dev)
    feeder = LoopFeeder(dec, streams)
    sel = torch.tensor(watch, device=dev)
    kept, events, feed_s, parse_s, split_s = [], [], [], [], []
    decoded = 0
    split = FloatSplitCheck(B, dev, exact) if float_pcm else None
    reset_launch_counts()
    for step in range(WARMUP_STEPS + timed):
        if step == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        t1 = time.perf_counter()
        feeder.step()
        t2 = time.perf_counter()
        check(dec.parse_step() > 0, f"step {step}: no active slot")
        feed_s.append(t2 - t1)
        parse_s.append(time.perf_counter() - t2)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wire = dec.upload()      # decode_step(fetch=False), in its parts
        pcm = dec.advance(wire)
        b.record()
        events.append((a, b))
        kept.append(pcm.index_select(0, sel))
        if split is not None:
            t3 = time.perf_counter()
            split.step(wire, pcm, dec._ix)
            split_s.append(time.perf_counter() - t3)
        decoded += 1
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) / timed * 1e3
    if split is None:
        launches = launch_counts(path, kernel, pool=True)
    else:
        ran = launched()
        k4 = "back_half" if exact else "back_half_raw"
        check(ran == {kernel: 2 * decoded, k4: 2 * decoded,
                      "l3_expand": decoded},
              f"{path}: launched {ran}, want {kernel} and {k4} "
              f"{2 * decoded} times each, l3_expand {decoded}")
        launches = ran[kernel]
    check(launches == per_frame * decoded,
          f"{path}: {launches} {kernel} launches for {decoded} frame steps")

    # the device half alone, replayed on the last uploaded wire
    from pdmp3_tpu_torch.models.decoder import (decode_frame_packed,
                                                decode_frame_packed_lsf)
    wire = dec._wires_t[dec._cur ^ 1][:dec._upload_len()].to(dev)
    state = clone_state(dec.state)
    if family:
        replay_ms = per_call_ms(
            lambda: decode_frame_packed_lsf(wire, state, B=B, family=family,
                                            exact=exact), timed)
    else:
        replay_ms = per_call_ms(
            lambda: decode_frame_packed(wire, state, B=B, exact=exact,
                                        float_pcm=float_pcm), timed)

    step_ms = float(np.median([a.elapsed_time(b)
                               for a, b in events[WARMUP_STEPS:]]))
    # audio seconds per step: B slots x the frame's samples over the
    # slot-weighted mean sample rate (44.1 kHz for the MPEG-1 basis)
    mean_rate = (float(np.mean([rates[s % len(rates)] for s in range(B)]))
                 if family else 44100.0)
    audio_s = B * 576 * ngr / mean_rate
    pcm = torch.cat(kept, 1).cpu().numpy()   # [watched, steps*576*ngr, 2]
    check(pcm.shape == (len(watch), decoded * 576 * ngr, 2)
          and pcm.dtype == (np.float32 if float_pcm else np.int16),
          f"{path}: PCM {pcm.shape} {pcm.dtype}")
    check(bool(pcm.any(axis=(1, 2)).all()), f"{path}: a slot is silent")
    pre = (("exact_" if exact else "") + (f"lsf{family}_" if family else "")
           + ("ff_" if frame_fused else "") + ("float_" if float_pcm else ""))
    return {f"{pre}{k}" if k not in ("batch_slots", "steps", "_pcm")
            else k: v for k, v in {
        "batch_slots": B,
        "steps": timed,
        "mean_sample_rate": mean_rate,
        "step_ms": step_ms,
        "device_replay_step_ms": replay_ms,
        "loop_ms_per_step": loop_ms,
        "host_feed_ms_per_step": float(np.median(feed_s[WARMUP_STEPS:]))
        * 1e3,
        "host_parse_ms_per_step": float(np.median(parse_s[WARMUP_STEPS:]))
        * 1e3,
        "aggregate_realtime_factor_per_chip": audio_s / (step_ms / 1e3),
        "aggregate_realtime_factor_per_chip_e2e": audio_s / (loop_ms / 1e3),
        "granules_per_sec": ngr * B / (step_ms / 1e3),
        "granules_per_sec_e2e": ngr * B / (loop_ms / 1e3),
        "kernel_launches": launches,
        "frame_steps": decoded,
        "_pcm": pcm,
        **({} if split is None else {
            "split_k4_launches": 2 * decoded,
            "bitwise_vs_decode_granules": split.result(),
            "split_check_host_ms_per_step":
            float(np.median(split_s[WARMUP_STEPS:])) * 1e3}),
    }.items()}


class FloatSplitCheck:
    """decode_granules(float_pcm=True) (the stage ops and K4, instance 7
    exact or 8 fast) on each step's uploaded wire from a state of its
    own, started equal to a fresh pool's, and its PCM against the
    step's: every slot bitwise.  Mismatches are counted on the card; one
    read at the end."""

    def __init__(self, n: int, dev, exact: bool, family: int = 0):
        from pdmp3_tpu_torch.models.decoder import init_state
        self.n, self.exact, self.family = n, exact, family
        self.state = init_state(n, dev)
        self.off = torch.zeros((), dtype=torch.int64, device=dev)
        self.samples = 0

    def step(self, wire, pcm, ix=None) -> None:
        """The check of one step: `wire` as uploaded, for an MPEG-1 pool
        its coded wire and `ix` the lines the pool widened from it."""
        from pdmp3_tpu_torch.models.decoder import (GranuleBatch,
                                                    codes_sections,
                                                    decode_granules,
                                                    wire_sections_lsf)
        if self.family:
            w = wire_sections_lsf(wire, self.n)
            ip = [w["is_pos"][0]]
        else:
            w = dict(codes_sections(wire, self.n), ix=ix)
            ip = [None, None]
        act = w["active"].view(-1)[:self.n].to(torch.int32)
        outs = []
        for g, is_pos in enumerate(ip):
            batch = GranuleBatch(
                w["ix"][g], w["scf_l"][g], w["scf_s"][g],
                w["meta"][g].to(torch.int32).contiguous(), act, g,
                self.family, is_pos)
            p, self.state = decode_granules(batch, self.state, self.exact,
                                            float_pcm=True)
            outs.append(p)
        want = torch.cat(outs, 1)
        self.off += (pcm.view(torch.int32) != want.view(torch.int32)).sum()
        self.samples += want.numel()

    def result(self) -> dict:
        off = int(self.off)
        check(off == 0, f"float PCM: {off} samples differ from "
                        "decode_granules(float_pcm=True) on the same wire")
        return {"compared_samples": self.samples, "differing": off}


def phase_float_pcm(streams: list[bytes], dev, watch: list[int],
                    s16: dict) -> dict:
    """Phase 17's routes: float-PCM serving fast and exact over
    NEW_TIMED_STEPS steps (instance 9 or 10 once per granule, every slot
    of every step bitwise equal to decode_granules(float_pcm=True), which
    launches K4 instance 8 or 7 once per granule on the same wire), each
    watched slot against the S16 PCM of the same frames (s16[exact]:
    phases 3 and 6): exact trunc(pcm x 32767) equal to S16, fast within
    FLOAT_TOL of S16 / 32767, except at the wrap (S16 -32767 where float
    PCM is at +1)."""
    res = {}
    for exact in (False, True):
        r = phase_main_path(streams, dev, watch, exact, float_pcm=True,
                            timed=NEW_TIMED_STEPS)
        f = r.pop("_pcm")
        ref = s16[exact][:, :f.shape[1]]
        q = np.trunc(f.astype(np.float64) * 32767)
        # the wrap: a sum whose x32767 escapes int32 upwards saturates at
        # +1 in float PCM and wraps to -32767 in S16
        wrap = (ref == -32767) & (f == 1)
        if exact:
            bad = (q != ref) & ~wrap
        else:
            bad = (np.abs(f - ref.astype(np.float32) / 32767) > FLOAT_TOL) \
                & ~wrap
        r["watched_samples"] = int(f.size)
        r["wrap_samples"] = int(wrap.sum())
        r["max_abs_vs_s16_over_32767"] = float(
            np.abs(f - ref.astype(np.float32) / 32767)[~wrap].max())
        check(not bad.any(), f"phase 17 exact={exact}: {int(bad.sum())} "
                             "float samples off the S16 PCM")
        res["exact" if exact else "fast"] = r
    return res


def phase_lsf_float_pcm(lspecs: list[tuple[bytes, dict]], dev,
                        family: int) -> dict:
    """Phase 32 for one LSF family, fast and exact: K4's raw sums against
    their plain version on the family's spectra (phase_k4_raw), then the
    float LSF route (K3's float instances 11 / 12) at B beside the K3
    pool and the split route (lsf_float_route)."""
    streams = [d for d, _ in lspecs]
    fr = parsed_frame(streams, dev, family)
    res = {"exact" if exact else "fast": {"k4": phase_k4_raw(
        fr, exact, family, f"phase 32 family {family}")}
        for exact in (False, True)}
    del fr
    for exact in (False, True):
        res["exact" if exact else "fast"].update(
            lsf_float_route(streams, dev, family, exact))
    return res


def lsf_float_route(streams: list[bytes], dev, family: int,
                    exact: bool) -> dict:
    """The float LSF route at B beside the S16 pool: a StreamDecoder of
    the family (K3) fed by LoopFeeder, WARMUP_STEPS + NEW_TIMED_STEPS
    steps; each step's uploaded wire goes through
    decode_frame_packed_lsf(float_pcm=True) on a state of its own (K3's
    float instance, 12 exact or 11 fast, once a step), through
    decode_granules(float_pcm=True) on another (the stage ops and K4,
    instance 7 exact or 8 fast, once a step), and then pool.advance
    decodes it with K3.  Every slot's float PCM bitwise equal to the
    split route's, and against the step's S16 PCM: exact trunc(pcm x
    32767) equal, fast within FLOAT_TOL of S16 / 32767, except at the
    wrap; the three steps timed with CUDA events on the uploaded
    wire."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.models.decoder import (decode_frame_packed_lsf,
                                                init_state,
                                                wire_sections_lsf)

    path = f"phase 32 family {family} exact={exact}"
    k4 = "back_half" if exact else "back_half_raw"
    k3 = "fused_granule_lsf" + ("_exact" if exact else "")
    kf = "fused_granule_lsf_float" + ("_exact" if exact else "")
    split = FloatSplitCheck(B, dev, exact, family)
    pool = StreamDecoder(B, family=family, exact=exact, device=dev)
    feeder = LoopFeeder(pool, streams)
    state = init_state(B, dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    wraps = torch.zeros((), dtype=torch.int64, device=dev)
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    events = []
    steps = WARMUP_STEPS + NEW_TIMED_STEPS
    reset_launch_counts()
    for step in range(steps):
        feeder.step()
        check(pool.parse_step() == B, f"{path}: step {step}: a slot "
                                      "starved")
        wire = pool.upload()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        pf, state = decode_frame_packed_lsf(wire, state, B=B, family=family,
                                            exact=exact, float_pcm=True)
        ev[1].record()
        pi = pool.advance(wire)
        ev[2].record()
        split.step(wire, pf)
        ev[3].record()
        events.append(ev)
        idle = wire_sections_lsf(wire, B)["active"] == 0
        ref = pi.to(torch.int32)
        # the wrap: a sum whose x32767 escapes int32 upwards saturates at
        # +1 in float PCM and wraps to -32767 in S16
        wrap = (ref == -32767) & (pf == 1)
        d = (pf - ref.to(torch.float32) / 32767).abs()
        if exact:
            bad = torch.trunc(pf.double() * 32767).to(torch.int32) != ref
        else:
            bad = d > FLOAT_TOL
        off += (bad & ~wrap).sum() + pf[idle].ne(0).sum() + \
            pi[idle].ne(0).sum()
        wraps += wrap.sum()
        worst = torch.maximum(worst, d.masked_fill(wrap, 0).max())
    torch.cuda.synchronize()
    ran = launched()
    check(ran == {kf: steps, k4: steps, k3: steps},
          f"{path}: launched {ran}, want {kf}, {k4} and {k3} {steps} "
          "times each")
    check(int(off) == 0, f"{path}: {int(off)} float samples off the S16 "
                         "PCM (or an idle slot audible)")
    timed = events[WARMUP_STEPS:]
    float_ms = float(np.median([e[0].elapsed_time(e[1]) for e in timed]))
    s16_ms = float(np.median([e[1].elapsed_time(e[2]) for e in timed]))
    split_ms = float(np.median([e[2].elapsed_time(e[3]) for e in timed]))
    return {"steps": NEW_TIMED_STEPS, "float_step_ms": float_ms,
            "s16_step_ms": s16_ms, "float_over_s16_step": float_ms / s16_ms,
            "split_float_step_ms": split_ms,
            "bitwise_vs_decode_granules": split.result(),
            "compared_samples": steps * B * 576 * 2,
            "wrap_samples": int(wraps),
            "max_abs_vs_s16_over_32767": float(worst),
            "launches": ran}


def replay_ab(streams: list[bytes], dev) -> dict:
    """Phase 15's device A/B: one parsed frame of wire replayed through
    decode_frame_packed on the per-granule route (two K1) and the
    frame-fused one (K5), alternating call by call."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.models.decoder import decode_frame_packed

    dec = StreamDecoder(B, device=dev)
    LoopFeeder(dec, streams).step()
    check(dec.parse_step() == B, "phase 15: not every slot parsed a frame")
    wire = torch.from_numpy(dec.wire[:dec._upload_len()].copy()).to(dev)
    state = clone_state(dec.state)
    del dec
    times = {False: [], True: []}
    try:
        for _ in range(TIMED_STEPS):
            for ff in (False, True):
                frame_fused_route(ff)
                times[ff].append(per_call_ms(
                    lambda: decode_frame_packed(wire, state, B=B), 1))
    finally:
        frame_fused_route(False)
    per, ff = float(np.median(times[False])), float(np.median(times[True]))
    return {"calls_each": TIMED_STEPS, "per_granule_replay_ms": per,
            "frame_fused_replay_ms": ff, "frame_fused_over_per_granule":
            ff / per}


def phase_sparse(streams: list[bytes], dev, watch: list[int],
                 dense_pcm: np.ndarray) -> dict:
    """Phase 16: SparseStreamDecoder with SPARSE_F frames per step on the
    frame-fused route, drained by decode_step_pipelined (each call
    returns the previous step's PCM; drain_pending the last), over
    SPARSE_STEPS steps: the frames of phase 3.  K5 launches once per
    frame; the watched slots' PCM is byte-equal to phase 3's."""
    from pdmp3_tpu_torch import LoopFeeder, SparseStreamDecoder
    from pdmp3_tpu_torch.models.decoder import soa_layout

    path = "phase 16 sparse frame-fused pipelined"
    dec = SparseStreamDecoder(B, frames_per_step=SPARSE_F, device=dev)
    feeder = LoopFeeder(dec, streams)
    kept, wire_bytes, loop_s = [], [], []
    frame_fused_route(True)
    reset_launch_counts()
    try:
        for step in range(SPARSE_STEPS):
            t0 = time.perf_counter()
            feeder.step()
            check(dec.parse_step() == B * SPARSE_F,
                  f"{path}: step {step} left a slot-frame idle")
            wire_bytes.append(dec.wire_bytes())
            out = dec.decode_step_pipelined()
            if out is not None:
                kept.append(out[watch])
            loop_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        kept.append(dec.drain_pending()[watch])
        drain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        frame_fused_route(False)
    check(dec.drain_pending() is None, f"{path}: a second drain")
    launches = launch_counts(path, "frame_fused")
    check(launches == SPARSE_F * SPARSE_STEPS,
          f"{path}: {launches} K5 launches for {SPARSE_STEPS} steps")
    pcm = np.concatenate(kept, 1)
    check(pcm.shape == dense_pcm.shape, f"{path}: PCM {pcm.shape} vs "
                                        f"{dense_pcm.shape}")
    check(np.array_equal(pcm, dense_pcm),
          f"{path}: watched PCM differs from the dense route's")
    dense = 2 * soa_layout(B, SPARSE_F)["total"]
    timed = loop_s[WARMUP_STEPS:]
    return {"batch_slots": B, "frames_per_step": SPARSE_F,
            "steps": SPARSE_STEPS, "k5_launches": launches,
            "loop_ms_per_step": float(np.median(timed)) * 1e3,
            "loop_ms_per_frame": float(np.median(timed)) * 1e3 / SPARSE_F,
            "final_drain_ms": drain_ms,
            "sparse_wire_bytes_per_step": float(np.mean(wire_bytes)),
            "dense_wire_bytes_per_step": dense,
            "sparse_over_dense_wire": float(np.mean(wire_bytes)) / dense,
            "watched_byte_equal_to_phase_3": True}


def phase_profile(streams: list[bytes], dev) -> dict:
    """torch.profiler over PROFILE_STEPS serving steps after 2 warm-up
    steps: device time by kernel / copy and the device's busy share of
    the loop's wall time (union of the device's activity intervals, so
    overlapping work is counted once).  Then the loop's host times at
    each parse-thread count of PARSE_THREADS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder

    dec = StreamDecoder(B, device=dev)
    feeder = LoopFeeder(dec, streams)

    def serve(n):
        feed, parse = [], []
        for _ in range(n):
            t1 = time.perf_counter()
            feeder.step()
            t2 = time.perf_counter()
            check(dec.parse_step() > 0, "phase 10: no active slot")
            t3 = time.perf_counter()
            dec.decode_step(fetch=False)
            feed.append(t2 - t1)
            parse.append(t3 - t2)
        return (float(np.median(feed)) * 1e3, float(np.median(parse)) * 1e3)

    serve(WARMUP_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feed_ms, parse_ms = serve(PROFILE_STEPS)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (b - a))
    check(bool(spans), "phase 10: the profiler saw no device activity")
    busy_us, end = 0.0, -np.inf
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    res = {"profiled_steps": PROFILE_STEPS,
           "window_ms_per_step": window_ms / PROFILE_STEPS,
           "host_feed_ms_per_step": feed_ms,
           "host_parse_ms_per_step": parse_ms,
           "device_busy_ms_per_step": busy_us / 1e3 / PROFILE_STEPS,
           "device_busy_share": busy_us / 1e3 / window_ms,
           "device_time_by_name": [
               {"name": name[:80], "count": n, "ms": us / 1e3}
               for name, (n, us) in top]}

    sweep = []
    for threads in PARSE_THREADS:
        dec.parse_threads = threads
        serve(WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed_ms, parse_ms = serve(SWEEP_STEPS)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) / SWEEP_STEPS * 1e3
        sweep.append({"parse_threads": threads, "loop_ms_per_step": loop_ms,
                      "host_feed_ms_per_step": feed_ms,
                      "host_parse_ms_per_step": parse_ms,
                      "aggregate_realtime_factor_per_chip_e2e":
                      B * 1152 / 44100.0 / (loop_ms / 1e3)})
    res["parse_thread_sweep"] = sweep
    return res


def check_no_launches(path: str) -> None:
    """No kernel launched since the last reset (a path that runs nothing
    on the card: the host parse)."""
    from pdmp3_tpu_torch.tools import launches

    counts = launches()
    check(not any(counts.values()), f"{path}: launched {counts}")


def serve_timed(dec, feeder, sel, steps: int, path: str) -> dict:
    """WARMUP_STEPS + steps of feed -> parse_step -> decode_step: step_ms
    (CUDA events around decode_step, median of the timed steps),
    loop_ms_per_step (host clock over the timed steps, one sync at the
    end), the replay of the last uploaded wire through the pool's device
    decode (device_replay_step_ms, per_call_ms), and the watched slots'
    PCM (_pcm, [watched, samples, 2])."""
    kept, events = [], []
    for step in range(WARMUP_STEPS + steps):
        if step == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        feeder.step()
        check(dec.parse_step() > 0, f"{path}: step {step}: no active slot")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        pcm = dec.decode_step(fetch=False)
        b.record()
        events.append((a, b))
        kept.append(pcm.index_select(0, sel))
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) / steps * 1e3
    wire = dec._wires_t[dec._cur ^ 1].to(dec.device)
    state = dec.state
    replay_ms = per_call_ms(lambda: dec._decode(wire), steps)
    dec.state = state
    return {"steps": steps,
            "step_ms": float(np.median([a.elapsed_time(b) for a, b
                                        in events[WARMUP_STEPS:]])),
            "device_replay_step_ms": replay_ms, "loop_ms_per_step": loop_ms,
            "_pcm": torch.cat(kept, 1).cpu().numpy()}


def l12_kernel(exact: bool, float_pcm: bool = False) -> str:
    """The launch counter of K7's instance in that precision and PCM
    type (both layers)."""
    return ("l12_synth" + ("_float" if float_pcm else "")
            + ("_exact" if exact else ""))


def phase_l12(dev) -> dict:
    """Phase 18: Layer I/II pools at B slots, both layers and precisions,
    NEW_TIMED_STEPS timed steps each, parsed on L12_PARSE_THREADS
    threads, K9 and K7 once a step and once a replayed step (K7 in the
    pool's instance) and nothing else; watched slots against the native
    decoder; Layer II float PCM, fast and exact, against the S16 of its
    precision."""
    from pdmp3_tpu_torch import L12StreamDecoder, LoopFeeder

    res = {}
    per_pool = WARMUP_STEPS + 2 * NEW_TIMED_STEPS

    def launches(path, kernel):
        n = launch_counts(path, kernel)
        check(n == per_pool, f"{path}: {n} {kernel} launches, want "
                             f"{per_pool}")
        return n

    for layer in (1, 2):
        specs = l12_corpus(layer)
        streams = [d for d, _ in specs]
        watch = watched_slots(specs, L12_FEATURES)
        sel = torch.tensor(watch, device=dev)
        pcms = {}
        for exact in (False, True):
            path = f"phase 18 layer {layer} exact={exact}"
            dec = L12StreamDecoder(B, layer=layer, exact=exact,
                                   parse_threads=L12_PARSE_THREADS,
                                   device=dev)
            reset_launch_counts()
            r = serve_timed(dec, LoopFeeder(dec, streams), sel,
                            NEW_TIMED_STEPS, path)
            r["kernel_launches"] = launches(path, l12_kernel(exact))
            pcms[exact] = r.pop("_pcm")
            r["vs_native"] = phase_correctness(pcms[exact], watch, specs,
                                               exact)
            spf = 32 * dec.S
            r["aggregate_realtime_factor_per_chip"] = (
                B * spf / 44100.0 / (r["step_ms"] / 1e3))
            r["aggregate_realtime_factor_per_chip_e2e"] = (
                B * spf / 44100.0 / (r["loop_ms_per_step"] / 1e3))
            res[f"layer{layer}_{'exact' if exact else 'fast'}"] = r
        for exact in (True, False) if layer == 2 else ():
            path = f"phase 18 layer 2 float PCM exact={exact}"
            dec = L12StreamDecoder(B, layer=2, exact=exact, float_pcm=True,
                                   parse_threads=L12_PARSE_THREADS,
                                   device=dev)
            reset_launch_counts()
            r = serve_timed(dec, LoopFeeder(dec, streams), sel,
                            NEW_TIMED_STEPS, path)
            r["kernel_launches"] = launches(path, l12_kernel(exact, True))
            f = r.pop("_pcm")
            d = np.abs(f - pcms[exact].astype(np.float32) / 32767)
            r["max_abs_vs_s16_over_32767"] = float(d.max())
            check(f.dtype == np.float32 and float(d.max()) <= FLOAT_TOL,
                  f"{path}: float PCM {float(d.max())} off its S16")
            res[f"layer2_{'exact' if exact else 'fast'}_float"] = r
    res["watched_slots_per_layer"] = len(watch)
    res["parse_threads"] = L12_PARSE_THREADS
    return res


def l12_frame(layer: int, dev) -> dict:
    """One natively parsed Layer I/II frame of phase 18's corpus for B
    slots on the card, as the pool's coded wire holds it (its sections
    body, side and geom: ``codes``) and as K9 requantizes it (sb f32
    [B,2,S,32]), nch a strided int16 view of meta, active int16 (the
    INACTIVE slots idle), and a random FIFO v0 [B,2,15,64]."""
    from pdmp3_tpu_torch import L12StreamDecoder, LoopFeeder
    from pdmp3_tpu_torch.models import l12 as L
    from pdmp3_tpu_torch.ops import l12_requant as RQ

    dec = L12StreamDecoder(B, layer=layer, parse_threads=L12_PARSE_THREADS,
                           device=dev)
    LoopFeeder(dec, [d for d, _ in l12_corpus(layer)]).step()
    check(dec.parse_step() == B, "phase 35: not every slot parsed a frame")
    wire = dec._wires_t[dec._cur].to(dev)
    del dec
    w = L.l12_sections(wire, B, layer)
    w["active"][list(INACTIVE)] = 0
    codes = (w["body"], w["side"], w["geom"])
    g = torch.Generator(device=dev).manual_seed(35 + layer)
    return {"sb": RQ.l12_requant(*codes, layer)[0],
            "nch": w["meta"][0, :, 0], "active": w["active"],
            "codes": codes,
            "v0": torch.randn((B, 2, 15, 64), generator=g, device=dev)
            * 0.1}


def lame_streams() -> list[bytes]:
    """The 64 LAME 128 kbps joint-stereo streams of the benchmark
    (``benchmark/streams``: 32 frames each, one after another)."""
    with open(LAME_44K1, "rb") as f:
        data = f.read()
    size = len(data) // 64
    return [data[k * size:(k + 1) * size] for k in range(64)]


def coded_step(streams: list[bytes], n: int, dev) -> dict:
    """One natively parsed frame of an n-slot MPEG-1 pool's coded wire on
    the card, as its upload takes it: its sections and the escapes
    used."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.models.decoder import codes_sections

    dec = StreamDecoder(n, parse_threads=8, device=dev)
    LoopFeeder(dec, streams).step()
    check(dec.parse_step() == n, "phase 37: not every slot parsed a frame")
    used = dec._esc_used.value
    wire = dec._wires_t[dec._cur][:dec._upload_len()].to(dev)
    return {"w": codes_sections(wire, n), "used": used, "slots": n}


def k10_bound(w: dict, used: int) -> dict:
    """K10's bound for one launch: each row's codes (288 B) and start
    (4 B) and the escapes it uses (2 B each) read, its lines (1,152 B)
    written."""
    from pdmp3_tpu_torch.ops import l3_expand as X

    rows = w["starts"].numel()
    return bound(rows * (X.CODE_BYTES + 4 + 2 * X.LINES) + 2 * used, 0)


def phase_k10(streams: list[bytes], dev) -> dict:
    """Phase 37, K10: the widening kernel against its plain version (on
    the card) on coded_step at B (phase 3's corpus) and at BENCH_SLOTS
    (the benchmark's LAME streams) and on a generated two-frame wire at
    BENCH_SLOTS whose rows hold up to 576 escapes: every line bitwise,
    one launch a call; the parsed wires timed with their bounds."""
    from pdmp3_tpu_torch.models import decoder as M
    from pdmp3_tpu_torch.ops import l3_expand as X
    from pdmp3_tpu_torch.testing import l3wire

    res = {}
    steps = {"corpus": coded_step(streams, B, dev),
             "lame": coded_step(lame_streams(), BENCH_SLOTS, dev)}
    rng = np.random.default_rng(37)
    dense = torch.zeros(M.soa_layout(BENCH_SLOTS, 2)["total"],
                        dtype=torch.int16)
    d = M.wire_sections(dense, BENCH_SLOTS, 2)
    ix = np.clip(np.round(rng.laplace(0, 1.5, tuple(d["ix"].shape))), -7, 7)
    big = rng.integers(8, 8207, ix.shape) * rng.choice([-1, 1], ix.shape)
    ix = np.where(rng.random(ix.shape) < 0.02, big, ix)
    ix[:, ::97] = big[:, ::97]               # rows of 576 escapes
    ix[:, 5::89] = 0                         # silent rows
    d["ix"].copy_(torch.from_numpy(ix.astype(np.int16)))
    d["active"].fill_(1)
    d["active"].view(-1)[3::11] = 0          # idle slot-frames
    coded = l3wire.coded_wire(dense, BENCH_SLOTS, 2).to(dev)
    g = M.codes_sections(coded, BENCH_SLOTS, 2)
    steps["generated"] = {"w": g, "used": g["esc"].numel(),
                          "slots": BENCH_SLOTS}
    reset_launch_counts()
    for name, st in steps.items():
        w = st["w"]
        args = (w["codes"], w["starts"], w["esc"])
        got = X.l3_expand(*args)
        want = X.l3_expand_ref(*args)
        torch.cuda.synchronize()
        eq = torch.equal(got, want)
        check(eq, f"phase 37 {name}: K10 differs from its plain version")
        res[name] = {"slots": st["slots"], "rows": w["starts"].numel(),
                     "escapes": st["used"], "bitwise_equal": eq}
    check(launch_counts("phase 37", "l3_expand") == len(steps),
          "phase 37: not one K10 launch a call")
    for name in ("corpus", "lame"):
        w, r = steps[name]["w"], res[name]
        out = torch.empty(tuple(w["codes"].shape[:-1]) + (X.LINES,),
                          dtype=torch.int16, device=dev)
        args = (w["codes"], w["starts"], w["esc"])
        kernel_timing(r, lambda: X.l3_expand(*args, out=out))
        r["plain_ms"] = plain_ms(lambda: X.l3_expand_ref(*args, out=out))
        r.update(k10_bound(w, steps[name]["used"]))
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
    res["max_abs_err"] = 0
    return res


def k9_bound(codes, layer: int) -> dict:
    """K9's bound for one launch over the slot-frames of `codes` (body,
    side, geom): each slot-frame's body up to its last code's byte in
    whole 16-byte chunks, its side record (384 B) and geom (4 B) read,
    its samples (2 x S x 32 f32) written; 4 f64 operations a sample."""
    from pdmp3_tpu_torch.ops import l12_requant as RQ

    geom = codes[2].reshape(-1, 2).to(torch.int64).cpu()
    used = (geom[:, 0] + 12 * geom[:, 1] + 7) // 8
    chunks = torch.where(used <= 0, 0, torch.clamp((used + 15) // 16 * 16,
                                                   max=RQ.BODY_BYTES))
    n = geom.shape[0]
    samples = n * 2 * RQ.steps(layer) * 32
    nbytes = int(chunks.sum()) + n * (RQ.SIDE_BYTES + 4) + 4 * samples
    return bound(nbytes, 0, f64_ops=4 * samples)


def phase_k9(dev, frames: dict) -> dict:
    """Phase 35, K9: the requantization kernel against its plain version
    (``ops.l12_requant.l12_requant_ref``, on the card) on each layer's
    l12_frame wire at B and on its first 1, 2 and 1,000 slots, bitwise
    (signed zeros included); timed at B with its bound."""
    from pdmp3_tpu_torch.ops import l12_requant as RQ

    res = {}
    for layer, fr in frames.items():
        what = f"phase 35 K9 layer {layer}"
        r = {}
        for n in (B, 1, 2, 1000):
            codes = [t[:, :n] for t in fr["codes"]]
            got = RQ.l12_requant(*codes, layer)
            want = RQ.l12_requant_ref(*codes, layer)
            torch.cuda.synchronize()
            eq = torch.equal(got.view(torch.int32), want.view(torch.int32))
            check(eq, f"{what} B={n}: K9 differs from its plain version")
            r[f"bitwise_equal_b{n}"] = eq
        out = torch.empty_like(fr["sb"][None])
        kernel_timing(r, lambda: RQ.l12_requant(*fr["codes"], layer,
                                                out=out))
        r["plain_ms"] = plain_ms(lambda: RQ.l12_requant_ref(
            *fr["codes"], layer, out=out))
        r.update(k9_bound(fr["codes"], layer))
        r["max_abs_err"] = 0.0
        res[layer] = r
    return res


def compare_k7(fr: dict, exact: bool, float_pcm: bool, what: str,
               v0=None) -> dict:
    """K7 and its plain version on the same operands from the FIFO v0
    (fr's by default): PCM bits and the FIFO bitwise, else the run
    fails; the largest PCM difference (0)."""
    from pdmp3_tpu_torch.models.l12 import L12State
    from pdmp3_tpu_torch.ops import l12_synth as K7

    v0 = fr["v0"] if v0 is None else v0
    ops = (fr["sb"], fr["nch"], fr["active"])
    pk, sk = K7.l12_synth_step(*ops, L12State(v0.clone()), exact, float_pcm)
    pr, sr = K7.l12_synth_step_ref(*ops, L12State(v0.clone()), exact,
                                   float_pcm)
    torch.cuda.synchronize()
    pcm_eq = torch.equal(pk.view(torch.uint8), pr.view(torch.uint8))
    v_eq = torch.equal(sk.v_blocks.view(torch.int32),
                       sr.v_blocks.view(torch.int32))
    check(pcm_eq and v_eq, f"{what}: K7 differs from its plain version "
                           f"(pcm {pcm_eq}, v_blocks {v_eq})")
    idle = fr["active"] == 0
    check(not pk[idle].any() and torch.equal(sk.v_blocks[idle], v0[idle]),
          f"{what}: an idle slot wrote PCM or its FIFO")
    err = (pk.double() - pr.double()).abs().max() if pk.numel() else 0
    return {"batch_slots": int(pk.shape[0]), "pcm_bitwise_equal": pcm_eq,
            "v_blocks_bitwise_equal": v_eq, "max_abs_err": float(err)}


def mirror_rows(fr: dict) -> dict:
    """fr with slots 7-10's subband samples replaced by the hazards of
    K7's mirrored NWIN rows: slot 7 silent (every dot +-0, whose sign the
    mirrored row's own sum sets), slot 8 rows whose dot with a unique
    row cancels to zero (two products that are exact negations, the rest
    +-0), slot 9 +-0 samples in even time steps and subnormal ones in
    odd ones, slot 10 +-inf in one row of each channel (NaN dots)."""
    from pdmp3_tpu_torch.ops.consts import host_consts

    nwin = host_consts(0)["nwin"]
    sb = fr["sb"].clone()
    S = sb.shape[2]
    rng = np.random.default_rng(35)
    cancel = np.zeros((2, S, 32), np.float32)
    for c in range(2):
        for t in range(S):
            r = (c * S + t) % 17                      # a unique row 0..16
            k1, k2 = rng.choice(32, 2, replace=False)
            cancel[c, t, k1] = nwin[r, k2]
            cancel[c, t, k2] = -nwin[r, k1]
    zeros = np.where(rng.random((2, (S + 1) // 2, 32)) < 0.5,
                     np.float32(-0.0), np.float32(0.0))
    sb[7] = 0.0
    sb[8] = torch.from_numpy(cancel).to(sb.device)
    sb[9, :, ::2] = torch.from_numpy(zeros).to(sb.device)
    sb[9, :, 1::2, :5] = 3e-41
    sb[10, 0, 3, 7] = float("inf")
    sb[10, 1, 5, 2] = float("-inf")
    return dict(fr, sb=sb)


def l12_bound(n_slots: int, n_active: int, S: int, exact: bool,
              float_pcm: bool) -> dict:
    """K7's bound for one step: per slot the int16 nch and active read
    and the PCM row written (S x 128 B, float S x 256 B); per active
    slot sb (S x 256 B) read and the FIFO (7,680 B) read and written;
    per active slot 2 x S x 64 matrixing dots of 32 terms (63
    operations), 2 x S x 32 FIR sums of 16 taps (32) and the quantize's
    multiply (f64 in exact S16)."""
    nbytes = (n_slots * (4 + S * 128 * (2 if float_pcm else 1))
              + n_active * (S * 256 + 2 * 7680))
    ops = n_active * (2 * S * 64 * 63 + 2 * S * 32 * 32)
    q = n_active * 2 * S * 32 * (not float_pcm)
    return bound(nbytes, ops + (0 if exact else q), f64_ops=q if exact
                 else 0)


def phase_k7(dev, frames: dict) -> dict:
    """Phase 35: K7's eight instances against their plain version on
    frames[layer] (l12_frame(layer)) at B (the corpus has mono slots),
    from its random FIFO and from one whose rows drive slots 0-4's sums
    to NaN, +-inf
    and past int32 with subnormal subband samples in slot 6; on
    mirror_rows(fr); at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3 with
    idle slots at the seams of the slot ring; bitwise (compare_k7); each
    instance timed at B, with its bound and launch geometry."""
    from pdmp3_tpu_torch.models.l12 import L12State
    from pdmp3_tpu_torch.ops import l12_synth as K7
    from pdmp3_tpu_torch.ops import launch as LA

    res = {}
    for layer, S in L12_S.items():
        fr = frames[layer]
        n_active = int((fr["active"] != 0).sum())
        hostile = fr["v0"].clone()
        for s, x in enumerate((float("nan"), float("inf"), float("-inf"),
                               3e38, -3e38)):
            hostile[s, s % 2, 5:9, 3:40] = x
        sub = dict(fr, sb=fr["sb"].clone())
        sub["sb"][6, :, :, :8] = 3e-39
        hazards = mirror_rows(fr)
        for exact in (False, True):
            for float_pcm in (False, True):
                name = l12_kernel(exact, float_pcm)
                what = f"phase 35 layer {layer} {name}"
                r = compare_k7(fr, exact, float_pcm, what)
                r["nan_inf_state"] = compare_k7(fr, exact, float_pcm,
                                                what + " NaN/inf state",
                                                hostile)
                r["subnormal_samples"] = compare_k7(
                    sub, exact, float_pcm, what + " subnormal samples")
                r["mirror_hazards"] = compare_k7(
                    hazards, exact, float_pcm,
                    what + " silent / cancelling / signed-zero rows")
                launch = LA.granule_launch_info(dev, exact, layer=layer,
                                                float_pcm=float_pcm)
                grid = launch["grid"]
                ragged = []
                for n in (1, 2, grid - 1, grid + 1, 2 * grid + 3):
                    act = fr["active"][:n].clone()
                    seams = [k for k in (grid - 1, grid, 2 * grid - 1,
                                         2 * grid, n - 1)
                             if 0 < k < n]
                    act[seams] = 0
                    rf = {"sb": fr["sb"][:n], "nch": fr["nch"][:n],
                          "active": act, "v0": hostile[:n]}
                    ragged.append(dict(idle_slots=seams, **compare_k7(
                        rf, exact, float_pcm, f"{what} B={n}")))
                r["ragged"] = ragged
                r["launch"] = launch
                ops = (fr["sb"], fr["nch"], fr["active"])
                sk = L12State(fr["v0"].clone())
                sr = L12State(fr["v0"].clone())
                kernel_timing(r, lambda: K7.l12_synth_step(
                    *ops, sk, exact, float_pcm))
                r["plain_ms"] = plain_ms(lambda: K7.l12_synth_step_ref(
                    *ops, sr, exact, float_pcm))
                r.update(l12_bound(B, n_active, S, exact, float_pcm))
                res[(layer, name)] = r
    return res


def phase_k8(dev) -> dict:
    """Phase 36: K8 against its plain version at B, 44.1 -> 48 kHz:
    int16 and f32 in and out, C = 1 and 2, steps of RESAMPLE_BLOCKS
    samples carrying the phase (one shorter than taps - 1), and the same
    sizes cut from [B, N + 1, 2] at sample 1 (off 16-byte alignment):
    outputs, carries and phases bitwise; then K8 timed at the serving
    pool's shape (N = 1,152, C = 2, int16 in and out) with its plain
    version, bound and geometry (k8_geometry: one bulk-staged chunk)."""
    from pdmp3_tpu_torch.ops import resample as RS
    from pdmp3_tpu_torch.ops.resample import StreamResampler

    g = torch.Generator(device=dev).manual_seed(36)
    cases, err = [], 0.0
    for C in (1, 2):
        for in_dt in (torch.int16, torch.float32):
            for out_dt in (torch.int16, torch.float32):
                k = StreamResampler(*RESAMPLE_PAIR, B, C, dtype=out_dt,
                                    device=dev)
                r = StreamResampler(*RESAMPLE_PAIR, B, C, dtype=out_dt,
                                    device=dev)
                what = f"phase 36 C={C} {in_dt} -> {out_dt}"
                for t, n in enumerate(RESAMPLE_BLOCKS):
                    x = torch.randn((B, n, C), generator=g, device=dev) * 9e3
                    if in_dt == torch.int16:
                        x = x.round().clamp(-32768, 32767).to(torch.int16)
                    n_out = (n * r.up - r.phase + r.down - 1) // r.down
                    yr, r.carry = RS.resample_block_ref(
                        r.carry, x, r.phase, r.up, r.down, r.H, n_out,
                        out_dt)
                    r.phase += n_out * r.down - n * r.up
                    yk = k(x)
                    torch.cuda.synchronize()
                    same = (torch.equal(yk.view(torch.uint8),
                                        yr.view(torch.uint8))
                            and torch.equal(k.carry.view(torch.int32),
                                            r.carry.view(torch.int32))
                            and k.phase == r.phase)
                    check(same, f"{what} step {t} (N={n}): K8 differs "
                                "from its plain version")
                    if yk.numel():
                        err = max(err, float((yk.double() - yr.double())
                                             .abs().max()))
                cases.append({"channels": C, "in": str(in_dt),
                              "out": str(out_dt),
                              "blocks": list(RESAMPLE_BLOCKS),
                              "bitwise_equal": True})
    # the same sizes off 16-byte alignment: a view of [B, N + 1, 2] from
    # sample 1 (its address and stream stride), int16 in and out
    k = StreamResampler(*RESAMPLE_PAIR, B, 2, device=dev)
    r = StreamResampler(*RESAMPLE_PAIR, B, 2, device=dev)
    for t, n in enumerate(RESAMPLE_BLOCKS):
        wide = (torch.randn((B, n + 1, 2), generator=g, device=dev) * 9e3)\
            .round().clamp(-32768, 32767).to(torch.int16)
        x = wide[:, 1:]
        n_out = (n * r.up - r.phase + r.down - 1) // r.down
        yr, r.carry = RS.resample_block_ref(r.carry, x, r.phase, r.up,
                                            r.down, r.H, n_out)
        r.phase += n_out * r.down - n * r.up
        yk = k(x)
        torch.cuda.synchronize()
        same = (torch.equal(yk, yr) and torch.equal(
            k.carry.view(torch.int32), r.carry.view(torch.int32))
            and k.phase == r.phase)
        check(same, f"phase 36 unaligned step {t} (N={n}): K8 differs "
                    "from its plain version")
    cases.append({"channels": 2, "in": str(torch.int16),
                  "out": str(torch.int16), "blocks": list(RESAMPLE_BLOCKS),
                  "stream_stride_off_16_bytes": True, "bitwise_equal": True})
    rs = StreamResampler(*RESAMPLE_PAIR, B, 2, device=dev)
    pcm = (torch.randn((B, 1152, 2), generator=g, device=dev) * 9e3).round()\
        .clamp(-32768, 32767).to(torch.int16)
    n_out = (1152 * rs.up + rs.down - 1) // rs.down
    args = (rs.carry, pcm, 0, rs.up, rs.down, rs.H, n_out, torch.int16)
    res = {"cases": cases, "max_abs_err": err, "batch_slots": B,
           "block": 1152, "n_out": n_out,
           "geometry": RS.k8_geometry(rs.up, rs.down, rs.taps, 2, n_out,
                                      1152, 0, 2, True)}
    kernel_timing(res, lambda: RS.resample_block(*args))
    res["plain_ms"] = plain_ms(lambda: RS.resample_block_ref(*args))
    taps = rs.taps
    res.update(bound(B * 1152 * 2 * 2 + B * n_out * 2 * 2
                     + 2 * B * (taps - 1) * 2 * 4 + rs.up * taps * 4,
                     B * n_out * 2 * (2 * taps - 1)))
    return res


def phase_join(streams: list[bytes], dev) -> dict:
    """Phase 19: in a serving pool (LoopFeeder over phase 3's streams,
    JOIN_LEAD_STEPS steps served), fast and exact, the slots JOIN_SLOTS
    joined to new 30-frame streams at JOINS (start, duration); the
    joined slots' PCM after drop_samples equal to the same window of the
    native decode (exact bitwise, fast within the fast contract)."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.host import native_decode_file
    from pdmp3_tpu_torch.testing import mp3gen

    res = {}
    for exact in (False, True):
        path = f"phase 19 exact={exact}"
        dec = StreamDecoder(B, exact=exact, device=dev)
        feeder = LoopFeeder(dec, streams)
        for _ in range(JOIN_LEAD_STEPS):
            feeder.step()
            check(dec.parse_step() == B, f"{path}: a slot starved")
            dec.decode_step(fetch=False)
        joins = []
        for k, (slot, (t0, dur)) in enumerate(zip(JOIN_SLOTS, JOINS)):
            data = mp3gen.make_stream(n_frames=30, seed=9900 + k,
                                      blocks="varied", mode=1,
                                      mode_extension=2, use_reservoir=True)
            feeder.release(slot)
            j = dec.join(slot, data, t0, dur)
            check(j is not None, f"{path}: empty join window")
            joins.append((slot, t0, data, j, []))
        sel = torch.tensor(JOIN_SLOTS, device=dev)
        reset_launch_counts()
        steps = 0
        t_start = time.perf_counter()
        while steps < 64 and not all(
                j.exhausted and len(got) * 1152 >= j.drop_samples
                + j.take_samples for _, _, _, j, got in joins):
            feeder.step()
            for _, _, _, j, _ in joins:
                j.pump()
            check(dec.parse_step() > 0, f"{path}: no active slot")
            pcm = dec.decode_step(fetch=False).index_select(0, sel).cpu()
            for k, (slot, _, _, _, got) in enumerate(joins):
                if dec.active[slot]:
                    got.append(pcm[k].numpy().tobytes())
            steps += 1
        seconds = time.perf_counter() - t_start
        kernel = "fused_granule_exact" if exact else "fused_granule"
        launches = launch_counts(path, kernel, pool=True)
        check(launches == 2 * steps, f"{path}: {launches} launches for "
                                     f"{steps} steps")
        slots = []
        for slot, t0, data, j, got in joins:
            blob = b"".join(got)
            window = blob[j.drop_samples * 4:
                          (j.drop_samples + j.take_samples) * 4]
            a = int(round(t0 * 44100)) * 4
            want = native_decode_file(data)[a:a + len(window)]
            check(len(window) == j.take_samples * 4 > 0
                  and len(want) == len(window),
                  f"{path}: slot {slot} window {len(window)} B")
            lsb, frac = pcm_error(
                torch.from_numpy(np.frombuffer(window, "<i2").copy()),
                torch.from_numpy(np.frombuffer(want, "<i2").copy()))
            check(window == want if exact
                  else lsb <= MAX_LSB and frac < MAX_FRAC,
                  f"{path}: slot {slot} {lsb} LSB on {frac:.4%} vs native")
            slots.append({"slot": slot, "start_s": t0,
                          "drop_samples": j.drop_samples,
                          "take_samples": j.take_samples,
                          "max_lsb": lsb, "frac_differing": frac})
        res["exact" if exact else "fast"] = {
            "steps_after_join": steps, "seconds": seconds,
            "kernel_launches": launches, "joins": slots}
    return res


def phase_resample(dev) -> dict:
    """Phase 20: StreamDecoder(resample_to=48000, sample_rate=44100) at B
    slots on the 44.1 kHz corpus, NEW_TIMED_STEPS timed steps: each
    step's length as the phase gives it; the watched slots within 1 LSB
    of the same resampler run on the CPU over the same slots' S16 PCM
    (an S16 pool fed alike); the resample step alone timed at B."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.ops.resample import StreamResampler

    specs = corpus_44k()
    streams = [d for d, _ in specs]
    watch = watched_slots(specs, [
        ("blocks", "long"), ("blocks", "short"), ("blocks", "mixed"),
        ("blocks", "varied"), ("mode", 1), ("mode", 3)])
    sel = torch.tensor(watch, device=dev)
    dec = StreamDecoder(B, exact=True, resample_to=48000, sample_rate=44100,
                        device=dev)
    s16 = StreamDecoder(B, exact=True, device=dev)
    fr, fs = LoopFeeder(dec, streams), LoopFeeder(s16, streams)
    cpu_rs = StreamResampler(44100, 48000, len(watch), 2, device="cpu")
    phase, lens, worst, events = 0, [], 0, []
    reset_launch_counts()
    for step in range(WARMUP_STEPS + NEW_TIMED_STEPS):
        fr.step()
        fs.step()
        check(dec.parse_step() == B and s16.parse_step() == B,
              "phase 20: a slot starved")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = dec.decode_step(fetch=False)
        b.record()
        events.append((a, b))
        ref = s16.decode_step(fetch=False).index_select(0, sel).cpu()
        n_out = (1152 * 160 - phase + 146) // 147
        phase += n_out * 147 - 1152 * 160
        check(tuple(out.shape) == (B, n_out, 2),
              f"phase 20: step {step} {tuple(out.shape)}, want {n_out}")
        want = cpu_rs(ref)
        got = out.index_select(0, sel).cpu()
        worst = max(worst, int((got.to(torch.int32)
                                - want.to(torch.int32)).abs().max()))
        lens.append(n_out)
    check(worst <= 1, f"phase 20: {worst} LSB off the CPU resampler")
    steps = WARMUP_STEPS + NEW_TIMED_STEPS
    # K10 once and K2 twice a step in each pool, K8 once a step in the
    # resampled one
    want = {"fused_granule_exact": 4 * steps, "l3_expand": 2 * steps,
            "resample": steps}
    check(launched() == want, f"phase 20: launched {launched()}, want "
                              f"{want}")
    torch.cuda.synchronize()
    pcm = torch.zeros((B, 1152, 2), dtype=torch.int16, device=dev)
    timing_rs = StreamResampler(44100, 48000, B, 2, device=dev)
    return {"steps": steps, "n_out_per_step": lens,
            "watched_max_lsb_vs_cpu": worst, "k8_launches": steps,
            "decode_and_resample_step_ms": float(np.median(
                [a.elapsed_time(b) for a, b in events[WARMUP_STEPS:]])),
            "resample_step_ms": plain_ms(lambda: timing_rs(pcm))}


def phase_files(specs: list[tuple[bytes, dict]], dev) -> dict:
    """Phase 21: decode_files_batched over FILE_COPIES copies of phase 3's
    streams (1,024 files), exact; gapless and window=(0.1, 0.2) on the
    first FILE_SUBSET files; layer=2 on 64 Layer II files;
    decode_files_scan over the 1,024 files, exact.  Every 64th file (and
    every file of the subsets) against the native decoder, the native
    window (metadata.decode_file_seek) or trim (decode_file_gapless)."""
    from pdmp3_tpu_torch import decode_files_batched
    from pdmp3_tpu_torch import metadata as MD
    from pdmp3_tpu_torch.host import PROFILE_L12, native_decode_file
    from pdmp3_tpu_torch.models.offline import decode_files_scan

    files = [d for d, _ in specs] * FILE_COPIES
    audio_s = sum(len(native_decode_file(d)) // (2 * (1 if sp["mode"] == 3
                                                      else 2))
                  / [44100, 48000, 32000][sp["sfreq"]]
                  for d, sp in specs) * FILE_COPIES

    def run(name, fn, want, every, kernel, prefix=False, steps=None,
            pool=True):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = launch_counts(f"phase 21 {name}", kernel, pool)
        check(launches > 0 and (steps is None or launches == steps(got)),
              f"phase 21 {name}: {launches} {kernel} launches")
        checked = 0
        for i in range(0, len(got), every):
            w = want(i)
            # the scan's frame count is the parse's, which may differ
            # from the native decoder's by its last two frames: compare
            # the aligned prefix
            n = min(len(got[i]), len(w)) if prefix else len(w)
            check(len(w) > 0 and got[i][:n] == w[:n]
                  and (len(got[i]) == n if not prefix
                       else n >= len(w) - 2 * 1152 * 2 * 2),
                  f"phase 21 {name}: file {i} differs from native")
            checked += 1
        return {"files": len(got), "seconds": sec,
                "files_per_second": len(got) / sec,
                "kernel_launches": launches, "files_checked": checked}

    res = {"files": len(files), "audio_seconds": audio_s}
    r = run("batched", lambda: decode_files_batched(
        files, exact=True, device=dev),
        lambda i: native_decode_file(files[i]), 64, "fused_granule_exact")
    r["audio_seconds_per_wall_second"] = audio_s / r["seconds"]
    res["batched_exact"] = r
    sub = files[:FILE_SUBSET]
    res["batched_gapless"] = run("gapless", lambda: decode_files_batched(
        sub, exact=True, gapless=True, device=dev),
        lambda i: MD.decode_file_gapless(sub[i])[0], 1,
        "fused_granule_exact")
    res["batched_window"] = run("window", lambda: decode_files_batched(
        sub, exact=True, window=(0.1, 0.2), device=dev),
        lambda i: MD.decode_file_seek(sub[i], 0.1, 0.2)[0], 1,
        "fused_granule_exact")
    l2specs = l12_corpus(2)
    l2 = [d for d, _ in l2specs]
    # one K7 launch a frame step: as many steps as the longest file has
    # frames (1,152 samples a channel)
    res["batched_layer2"] = run("layer 2", lambda: decode_files_batched(
        l2, exact=True, layer=2, device=dev),
        lambda i: native_decode_file(l2[i], profile=PROFILE_L12), 1,
        "l12_synth_exact", steps=lambda got: max(
            len(g) // (1152 * 2 * (1 if sp["mode"] == 3 else 2))
            for g, (_, sp) in zip(got, l2specs)))
    r = run("scan", lambda: decode_files_scan(files, exact=True, device=dev),
            lambda i: native_decode_file(files[i]), 64,
            "fused_granule_exact", prefix=True, pool=False)
    r["audio_seconds_per_wall_second"] = audio_s / r["seconds"]
    res["scan_exact"] = r
    return res


def sharded_route(path: str, specs: list[tuple[bytes, dict]], dev,
                  watch: list[int], pools: dict, kernel: str | None,
                  per_frame: int, exact: bool) -> dict:
    """One route of phase 22: the sharded and the unsharded pool
    (pools["sharded"], pools["unsharded"]) fed alike by LoopFeeder from
    `specs`, WARMUP_STEPS + NEW_TIMED_STEPS steps in lockstep, the pool
    that goes first alternating step by step.  Each pool's step (feed,
    parse, decode) runs between two synchronisations: loop_ms_per_step is
    its host-clock time, step_ms CUDA events around decode_step.  Every
    step's PCM must be bitwise equal between the pools; `kernel`
    launches per_frame times per shard and step; the
    watched slots of the sharded pool against the native decoder; the
    replay of each pool's last wire, interleaved (sharded, unsharded,
    unsharded, sharded).  Then the pipelined drain (sharded_pipelined):
    the pools in lockstep on decode_step_pipelined, and the free-running
    loops timed."""
    from pdmp3_tpu_torch import LoopFeeder

    streams = [d for d, _ in specs]
    feeders = {k: LoopFeeder(d, streams) for k, d in pools.items()}
    shards = {"sharded": len(pools["sharded"].pools), "unsharded": 1}
    sel = torch.tensor(watch, device=dev)
    events = {k: [] for k in pools}
    loop_s = {k: [] for k in pools}
    launches = {k: 0 for k in pools}
    kept = []
    steps = WARMUP_STEPS + NEW_TIMED_STEPS

    def step_launches(k: str) -> int:
        """The launches of `kernel` by pool k since the last reset."""
        return launch_counts(f"{path} {k}", kernel, pool=True)

    def check_launches(what: str, counts: dict, n_steps: int) -> None:
        for k in pools:
            want = per_frame * shards[k] * n_steps
            check(counts[k] == want,
                  f"{path} {k} {what}: {counts[k]} {kernel} launches for "
                  f"{n_steps} steps over {shards[k]} shards")
            launches[k] += counts[k]

    counts = {k: 0 for k in pools}
    for step in range(steps):
        order = sorted(pools, reverse=step % 2 == 1)
        out = {}
        for k in order:
            dec = pools[k]
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feeders[k].step()
            check(dec.parse_step() == B, f"{path} {k}: a slot starved")
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            pcm = dec.decode_step(fetch=False)
            b.record()
            torch.cuda.synchronize()
            loop_s[k].append(time.perf_counter() - t0)
            events[k].append((a, b))
            counts[k] += step_launches(k)
            out[k] = torch.cat(pcm) if isinstance(pcm, list) else pcm
        check(torch.equal(out["sharded"], out["unsharded"]),
              f"{path}: step {step}: the sharded PCM differs from the "
              "unsharded pool's")
        kept.append(out["sharded"].index_select(0, sel))
    check_launches("synchronous", counts, steps)

    def replay(k):
        dec = pools[k]
        parts = getattr(dec, "pools", [dec])
        wires = [p._wires_t[p._cur ^ 1][:p._upload_len()].to(dev)
                 for p in parts]
        return per_call_ms(lambda: [p._decode(w)
                                    for p, w in zip(parts, wires)], steps)
    replay_ms = {k: [] for k in pools}
    for k in ("sharded", "unsharded", "unsharded", "sharded"):
        replay_ms[k].append(replay(k))
    res = {"steps": steps, "shards": shards["sharded"],
           "kernel": kernel, "launches": launches,
           "vs_native": phase_correctness(torch.cat(kept, 1).cpu().numpy(),
                                          watch, specs, exact)}
    for k in pools:
        res[k] = {
            "step_ms": float(np.median([a.elapsed_time(b) for a, b
                                        in events[k][WARMUP_STEPS:]])),
            "device_replay_step_ms": float(np.mean(replay_ms[k])),
            "loop_ms_per_step": float(np.mean(loop_s[k][WARMUP_STEPS:]))
            * 1e3}
    res["sharded_over_unsharded_loop_ms"] = (
        res["sharded"]["loop_ms_per_step"]
        / res["unsharded"]["loop_ms_per_step"])
    res["pipelined"] = sharded_pipelined(path, pools, feeders, step_launches,
                                         check_launches)
    return res


def sharded_pipelined(path: str, pools: dict, feeders: dict, step_launches,
                      check_launches) -> dict:
    """Phase 22's pipelined drain for one route: both pools on
    decode_step_pipelined in lockstep over WARMUP_STEPS + NEW_TIMED_STEPS
    steps (the pool that goes first alternating), every call's PCM (the
    previous step's; None first) and drain_pending's flush bitwise equal
    between them, the launches checked; then each pool's free-running
    loop of NEW_TIMED_STEPS steps, pipelined (one drain_pending at its
    end) and synchronous (decode_step, which fetches every shard), in
    the order sharded pipelined, sharded synchronous, unsharded
    pipelined, unsharded synchronous and back: loop_ms_per_step on the
    host clock from a synchronisation to the last PCM on the host, and
    the part of it spent in parse_step; and host_concat_ms, the host
    time of joining the shards' PCM into one new array (median of 5)."""
    steps = WARMUP_STEPS + NEW_TIMED_STEPS
    counts = {k: 0 for k in pools}
    for step in range(steps + 1):
        out = {}
        for k in sorted(pools, reverse=step % 2 == 1):
            reset_launch_counts()
            if step < steps:
                feeders[k].step()
                check(pools[k].parse_step() == B,
                      f"{path} {k} pipelined: a slot starved")
                out[k] = pools[k].decode_step_pipelined()
            else:
                out[k] = pools[k].drain_pending()
                check(pools[k].drain_pending() is None,
                      f"{path} {k}: a second drain returned PCM")
            counts[k] += step_launches(k)
        if step == 0:
            check(out["sharded"] is None and out["unsharded"] is None,
                  f"{path}: the first pipelined call returned PCM")
            continue
        check(out["sharded"] is not None and np.array_equal(
            out["sharded"], out["unsharded"]),
            f"{path}: pipelined call {step} (the flush at {steps}): the "
            "sharded PCM differs from the unsharded pool's")
    check_launches("pipelined", counts, steps)
    # the host copy that joins the shards' PCM (np.concatenate into a new
    # array, as the sharded pool's fetch does), on the flush's halves
    parts = np.array_split(out["sharded"], len(pools["sharded"].pools))
    concat_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.concatenate(parts)
        concat_s.append(time.perf_counter() - t0)

    def loop(k: str, pipelined: bool) -> tuple[float, float]:
        """(loop ms, of which parse_step ms) per step."""
        dec = pools[k]
        reset_launch_counts()
        torch.cuda.synchronize()
        parse_s = 0.0
        t0 = time.perf_counter()
        for _ in range(NEW_TIMED_STEPS):
            feeders[k].step()
            t1 = time.perf_counter()
            check(dec.parse_step() == B, f"{path} {k}: a slot starved")
            parse_s += time.perf_counter() - t1
            if pipelined:
                dec.decode_step_pipelined()
            else:
                dec.decode_step()
        if pipelined:
            dec.drain_pending()
        loop_s = time.perf_counter() - t0
        timed[k] += step_launches(k)
        return (loop_s / NEW_TIMED_STEPS * 1e3,
                parse_s / NEW_TIMED_STEPS * 1e3)

    timed = {k: 0 for k in pools}
    order = [(k, p) for k in ("sharded", "unsharded") for p in (True, False)]
    ms = {kp: [] for kp in order}
    parse_ms = {kp: [] for kp in order}
    for kp in order + order[::-1]:
        loop_ms, p_ms = loop(*kp)
        ms[kp].append(loop_ms)
        parse_ms[kp].append(p_ms)
    check_launches("timed loops", timed, 4 * NEW_TIMED_STEPS)
    res = {"lockstep_calls": steps + 1, "steps_per_loop": NEW_TIMED_STEPS,
           "trials": 2, "host_concat_ms": float(np.median(concat_s)) * 1e3,
           "pcm_bytes_per_step": int(out["sharded"].nbytes)}
    for k in pools:
        res[k] = {"pipelined_loop_ms_per_step": ms[(k, True)],
                  "sync_loop_ms_per_step": ms[(k, False)],
                  "pipelined_parse_ms_per_step": parse_ms[(k, True)],
                  "sync_parse_ms_per_step": parse_ms[(k, False)]}
    mean = {kp: float(np.mean(v)) for kp, v in ms.items()}
    res["sharded_over_unsharded_pipelined"] = (
        mean[("sharded", True)] / mean[("unsharded", True)])
    res["sharded_over_unsharded_sync"] = (
        mean[("sharded", False)] / mean[("unsharded", False)])
    res["sharded_pipelined_over_sync"] = (
        mean[("sharded", True)] / mean[("sharded", False)])
    return res


def phase_sharded(specs: list[tuple[bytes, dict]],
                  lsf_specs: list[tuple[bytes, dict]], dev,
                  watch: list[int]) -> dict:
    """Phase 22: serving over a mesh of SHARDS shards of the card against
    the unsharded pool (sharded_route), MPEG-1 fast (K1) and exact (K2)
    on phase 3's corpus, MPEG-2 exact (K3) on phase 11's family-1 corpus
    and Layer II exact (K7) on phase 18's; then
    decode_granules_sharded on phase 2's kind of frame (idle slots, a
    random state) against the unsharded K1 step: PCM bitwise and the
    same clipped count."""
    from pdmp3_tpu_torch import (L12StreamDecoder, ShardedL12StreamDecoder,
                                 ShardedStreamDecoder, StreamDecoder,
                                 make_mesh)

    mesh = make_mesh([dev] * SHARDS)
    l2specs = l12_corpus(2)
    threads = SHARDED_PARSE_THREADS

    def layer3(exact, family=0):
        return {"sharded": ShardedStreamDecoder(
                    B, mesh, exact=exact, family=family,
                    parse_threads=threads),
                "unsharded": StreamDecoder(B, exact=exact, family=family,
                                           parse_threads=threads,
                                           device=dev)}
    routes = {
        "mpeg1_fast": (specs, watch, lambda: layer3(False),
                       "fused_granule", 2, False),
        "mpeg1_exact": (specs, watch, lambda: layer3(True),
                        "fused_granule_exact", 2, True),
        "mpeg2_exact": (lsf_specs, watched_slots(lsf_specs),
                        lambda: layer3(True, 1), "fused_granule_lsf_exact",
                        1, True),
        "layer2_exact": (l2specs, watched_slots(l2specs, L12_FEATURES),
                         lambda: {
                             "sharded": ShardedL12StreamDecoder(
                                 B, 2, mesh, exact=True,
                                 parse_threads=threads),
                             "unsharded": L12StreamDecoder(
                                 B, layer=2, exact=True,
                                 parse_threads=threads, device=dev)},
                         "l12_synth_exact", 1, True)}
    res = {"mesh": [str(d) for d in mesh.devices],
           "parse_threads": threads}
    for name, (sp, w, make, kernel, per_frame, exact) in routes.items():
        res[name] = sharded_route(f"phase 22 {name}", sp, dev, w, make(),
                                  kernel, per_frame, exact)
    res["clipped"] = sharded_clipped([d for d, _ in specs], mesh, dev)
    return res


def sharded_clipped(streams: list[bytes], mesh, dev) -> dict:
    """decode_granules_sharded over `mesh` on granule 0 of a parsed frame
    at B (INACTIVE slots idle, a random state) against the unsharded K1
    step: PCM and state bitwise, the clipped counts equal (and not 0:
    the random state drives samples to the rails)."""
    from pdmp3_tpu_torch import decode_granules_sharded
    from pdmp3_tpu_torch.models.decoder import GranuleBatch
    from pdmp3_tpu_torch.ops.fused_step import fused_granule_step
    from pdmp3_tpu_torch.parallel import place_batch, place_state

    fr = parsed_frame(streams, dev)
    args = granule_args(fr, 0)
    reset_launch_counts()
    pcms, states, clipped = decode_granules_sharded(
        place_batch(GranuleBatch(*args), mesh), place_state(fr["st0"], mesh),
        mesh)
    launches = launch_counts("phase 22 decode_granules_sharded",
                             "fused_granule")
    check(launches == mesh.size, f"phase 22: {launches} K1 launches for "
                                 f"{mesh.size} shards")
    pcm, st = fused_granule_step(*args, clone_state(fr["st0"]))
    check(torch.equal(torch.cat(pcms), pcm),
          "phase 22: decode_granules_sharded PCM differs from unsharded")
    for name in ("store", "v_blocks", "prev_lines"):
        check(torch.equal(torch.cat([getattr(s, name) for s in states])
                          .view(torch.int32),
                          getattr(st, name).view(torch.int32)),
              f"phase 22: decode_granules_sharded {name} differs")
    want = int(((pcm == 32767) | (pcm == -32767)).sum())
    check(int(clipped) == want > 0,
          f"phase 22: clipped {int(clipped)}, unsharded PCM {want}")
    return {"clipped": int(clipped), "launches": launches}


def rank_main(rank: int, port: int, specs: list[tuple[bytes, dict]],
              watch: list[int], threads: int, dev, out_path: str) -> None:
    """One rank of phase 23 (a spawned process): a gloo group of RANKS
    ranks over localhost TCP, MultiHostStreamDecoder(B, exact=True) on
    the card `dev` over this rank's B / RANKS slots, each fed its stream once
    (topped up as its ring frees), stepped until global_active reads 0;
    K2 twice per step; the watched slots bitwise against the native
    decoder; its results as JSON in out_path."""
    import datetime

    import torch.distributed as dist

    from pdmp3_tpu_torch import MultiHostStreamDecoder

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=RANKS,
        rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        dec = MultiHostStreamDecoder(B, device=dev, exact=True,
                                     parse_threads=threads)
        data = [specs[(rank * dec.n + s) % len(specs)][0]
                for s in range(dec.n)]
        fed = [0] * dec.n
        sel = torch.tensor(watch, device=dev)
        kept, steps = [], 0
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            for s in range(dec.n):
                if fed[s] < len(data[s]):
                    n = min(dec.inbuf_free(s), len(data[s]) - fed[s])
                    check(dec.feed(s, data[s][fed[s]:fed[s] + n]) == 0,
                          f"phase 23 rank {rank}: feed of slot {s} failed")
                    fed[s] += n
            if dec.global_active(dec.parse_step()) == 0:
                break
            kept.append(dec.decode_step(fetch=False).index_select(0, sel))
            steps += 1
            check(steps <= 2 * FRAMES_PER_STREAM,
                  f"phase 23 rank {rank}: the streams did not end")
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) / steps * 1e3
        launches = launch_counts(f"phase 23 rank {rank}",
                                 "fused_granule_exact", pool=True)
        check(launches == 2 * steps, f"phase 23 rank {rank}: {launches} "
                                     f"K2 launches for {steps} steps")
        # local slot s serves stream (rank * n + s) % 64 == s % 64
        slots = phase_correctness(torch.cat(kept, 1).cpu().numpy(), watch,
                                  specs, exact=True)
        with open(out_path, "w") as f:
            json.dump({"rank": rank, "slots": dec.n, "steps": steps,
                       "parse_threads": threads, "launches": launches,
                       "loop_ms_per_step": loop_ms, "vs_native": slots}, f)
    finally:
        dist.destroy_process_group()


def phase_ranks(specs: list[tuple[bytes, dict]], watch: list[int],
                dev) -> dict:
    """Phase 23: RANKS spawned processes on the card `dev` (rank_main),
    each with half the host's cores as parse threads.  A rank that exits
    non-zero or is alive after RANK_TIMEOUT_S fails the phase, and every
    rank still running is killed."""
    import multiprocessing
    import os
    import socket
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    threads = max(1, (os.cpu_count() or RANKS) // RANKS)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(RANKS)]
        procs = [ctx.Process(target=rank_main, args=(
            r, port, specs, watch, threads, dev, outs[r]))
            for r in range(RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            while (any(p.is_alive() for p in procs)
                   and time.perf_counter() - t0 < RANK_TIMEOUT_S
                   and all(p.exitcode in (None, 0) for p in procs)):
                time.sleep(0.1)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in procs:
                p.join()
        check(not alive and all(p.exitcode == 0 for p in procs),
              f"phase 23: rank exit codes {[p.exitcode for p in procs]} "
              f"after {time.perf_counter() - t0:.1f} s")
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    return {"ranks": ranks, "seconds": time.perf_counter() - t0,
            "note": "both ranks time-slice one card: correctness and the "
                    "host side, not multi-GPU throughput"}


def phase_entry(dev) -> dict:
    """Phase 24: entry("cuda")'s step launches K1 once and equals its
    plain version bitwise (PCM and state); dryrun_multichip over
    DRYRUN_SHARDS shards of the card passes, with K1, K3 and K7 (fast)
    once per shard and once unsharded."""
    from pdmp3_tpu_torch.entry import dryrun_multichip, entry
    from pdmp3_tpu_torch.ops.fused_step import fused_granule_step_ref

    step, (batch, state) = entry("cuda")
    ref = clone_state(state)
    reset_launch_counts()
    pcm, state = step(batch, state)
    check(launch_counts("phase 24 entry", "fused_granule") == 1,
          "phase 24: the entry step did not launch K1 once")
    want, ref = fused_granule_step_ref(batch.ix, batch.scf_l, batch.scf_s,
                                       batch.meta, batch.active, batch.gr1,
                                       ref, exact=False)
    check(torch.equal(pcm, want) and bool(pcm.any()),
          "phase 24: the entry step's PCM differs from its plain version")
    for name in ("store", "v_blocks", "prev_lines"):
        check(torch.equal(getattr(state, name).view(torch.int32),
                          getattr(ref, name).view(torch.int32)),
              f"phase 24: the entry step's {name} differs")
    reset_launch_counts()
    dryrun_multichip(DRYRUN_SHARDS, "cuda")
    counts = launched()
    want_counts = {"fused_granule": DRYRUN_SHARDS + 1,
                   "fused_granule_lsf": DRYRUN_SHARDS + 1,
                   "l12_synth": DRYRUN_SHARDS + 1}
    check(counts == want_counts, f"phase 24: dryrun_multichip launched "
                                 f"{counts}, want {want_counts}")
    return {"entry_pcm_shape": list(pcm.shape), "entry_k1_launches": 1,
            "dryrun_shards": DRYRUN_SHARDS, "dryrun_launches": counts}


def phase_serving_diff(dev) -> dict:
    """Phase 25: tools.serving_diff over DIFF_STREAMS random streams, fast
    (K1) then exact (K2) through SparseStreamDecoder, each stream against
    native (and the reference where it builds): exact 0 LSB, fast <= 1
    LSB on < 1%, each kernel twice per step (the tool checks all of
    it)."""
    from pdmp3_tpu_torch.tools import serving_diff

    reset_launch_counts()
    res = serving_diff.run(DIFF_STREAMS, DIFF_SEED_BASE, dev)
    ran = launched()
    check(res["exact"]["native"]["worst_lsb"] == 0
          and res["fast"]["native"]["worst_lsb"] <= MAX_LSB,
          f"phase 25: {res}")
    check(ran == {"fused_granule": 2 * res["fast"]["steps"],
                  "fused_granule_exact": 2 * res["exact"]["steps"]},
          f"phase 25: launched {ran}")
    return {**res, "launches": ran}


def phase_scale_sim(dev) -> dict:
    """Phase 26: tools.scale_sim at SCALE_SLOTS slots over SCALE_SHARDS
    shards of the card, SCALE_STEPS timed steps of K1 on every shard;
    every slot's PCM and state bitwise against the plain version on the
    four archetypes, tiled (the tool checks)."""
    from pdmp3_tpu_torch.tools import scale_sim

    reset_launch_counts()
    res = scale_sim.run(SCALE_SLOTS, SCALE_SHARDS, SCALE_STEPS, dev)
    ran = launched()
    # the warm-up and timed steps on every shard
    want = (SCALE_STEPS + 1) * SCALE_SHARDS
    check(ran == {"fused_granule": want}, f"phase 26: launched {ran}, "
                                          f"want {want} K1")
    return {**res, "launches": ran}


def phase_wire_profile(streams: list[bytes], dev) -> dict:
    """Phase 27: tools.wire_profile, dense against sparse wire at B on
    phase 3's streams: stages, bytes, buckets, WIRE_TRIALS alternating
    trials of the pipelined loop; K1 twice per decode step the tool
    ran, K10 once per step of the dense pool (its coded wire)."""
    from pdmp3_tpu_torch.tools import wire_profile

    reset_launch_counts()
    res = wire_profile.run(streams, B, WIRE_STEPS, WIRE_E2E_S, WIRE_TRIALS,
                           WIRE_TRIAL_S, dev)
    ran = launched()
    want = {"fused_granule": 2 * res["decode_steps"],
            "l3_expand": res["dense_decode_steps"]}
    check(ran == want, f"phase 27: launched {ran}, want {want}")
    return {**res, "launches": ran}


def phase_multihost_soak() -> dict:
    """Phase 28: one tools.multihost_soak round whose draw gives
    SOAK_RANKS ranks, spawned on the card, exact (K2), every slot
    bitwise against native; a rank that fails or outlives RANK_TIMEOUT_S
    fails the run, the others killed (the tool checks)."""
    from pdmp3_tpu_torch.tools import multihost_soak

    seed = multihost_soak.seed_with_procs(SOAK_RANKS)
    res = multihost_soak.run_round(seed, "cuda", RANK_TIMEOUT_S)
    check(res["ok"] and res["procs"] == SOAK_RANKS, f"phase 28: {res}")
    # each rank counts its own launches (its own process): K2 twice and
    # K10 once per step with an active local slot, and nothing else
    for r in res["ranks"]:
        want = {"fused_granule_exact": 2 * r["steps_with_work"],
                "l3_expand": r["steps_with_work"]}
        check(r["steps_with_work"] > 0 and r["launches"] == want,
              f"phase 28: rank {r['rank']} launched {r['launches']}, "
              f"want {want}")
    ran = sum(r["launches"]["fused_granule_exact"] for r in res["ranks"])
    return {**res, "launches": {"fused_granule_exact": ran}}


def phase_parse_scaling(dev, k1_ms: float) -> dict:
    """Phase 29: tools.parse_scaling at PARSE_SLOTS slots, PARSE_SECONDS
    per thread count (1, 2, 4, ... up to the host's cores), the stage
    split, the serving loop's parse, and cores_to_saturate_card from
    phase 2's K1 device time."""
    import os

    from pdmp3_tpu_torch.tools import parse_scaling

    reset_launch_counts()
    res = parse_scaling.run(
        PARSE_SLOTS, PARSE_SECONDS,
        parse_scaling.thread_counts(os.cpu_count() or 1), 1, dev,
        k1_device_ms=k1_ms)
    check_no_launches("phase 29")
    check(res["cores_to_saturate_card"] is not None
          and res["per_core_frames_per_sec"] > 0, f"phase 29: {res}")
    return res


def phase_resample_sweep(dev) -> dict:
    """Phase 30: tools.resample_sweep over every pair on the card, each
    at >= 85 dB passband SNR (the tool checks), K8 once a block."""
    from pdmp3_tpu_torch.tools import resample_sweep

    reset_launch_counts()
    res = resample_sweep.run(resample_sweep.PAIRS, dev)
    check(launched() == {"resample": res["blocks"]},
          f"phase 30: launched {launched()} for {res['blocks']} blocks")
    check(res["worst_snr_db"] >= resample_sweep.BAR_DB, f"phase 30: {res}")
    return res


def phase_soak(dev) -> dict:
    """Phase 31: tools.soak over SOAK_STREAMS format-matrix streams,
    native and oracle (and the reference where it builds), every
    SOAK_TORCH_EVERY-th stream also TorchDSP(exact) on the card (K4)."""
    import tempfile

    from pdmp3_tpu_torch.tools import soak

    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        res = soak.run(0, SOAK_STREAMS, "mpeg1", SOAK_TORCH_EVERY, dev, tmp)
    ran = launched()
    check(not res["failures"] and res["tally"]["ok"] > 0, f"phase 31: "
          f"{res['failures'][:3]}")
    check(set(ran) == {"back_half"}, f"phase 31: launched {ran}")
    return {**res, "launches": ran}


def phase_bench(dev) -> dict:
    """Phase 33: pdmp3_tpu_torch.bench.run at BENCH_SIZES on the card;
    its attestations, its rates and its launches checked (the bench
    checks each measurement's launches against the steps it ran; this
    phase checks the totals through the launch counters and the window
    counts from the sizes)."""
    import math

    from pdmp3_tpu_torch import bench as PB
    from pdmp3_tpu_torch.host import native_decode_file
    from pdmp3_tpu_torch.testing import mp3gen

    sz = PB.Sizes(sweep=(B,), **BENCH_SIZES)
    # the frames of the exact attestation's streams, by the native
    # decoder; TorchDSP launches K4 twice a frame
    attest_frames = sum(
        len(native_decode_file(mp3gen.make_stream(**spec)))
        // PB.FRAME_BYTES for spec in PB.ATTEST_STREAMS)
    at_size_steps = 1 + 2 * PB.RECORDED + sz.repeats * sz.at_size_steps
    reset_launch_counts()
    line = PB.run(sz, dev)
    counts = launched()
    check(counts == line["launches"]["total"],
          f"phase 33: launched {counts}, the bench counted "
          f"{line['launches']['total']}")
    window = sz.group + sz.repeats * PB.timed_steps(sz, sz.steps)
    short = sz.group + sz.repeats * PB.timed_steps(sz, sz.short_steps)
    want = {f"kernel_fast_B{B}": {"fused_granule": window},
            "kernel_exact": {"fused_granule_exact": window},
            "split_fast": {"back_half": window},
            "split_exact": {"back_half": window},
            "lsf_kernel_fast": {"fused_granule_lsf": short},
            "attest_kernel_vs_split": {"fused_granule": 4,
                                       "fused_granule_exact": 4,
                                       "back_half": 8},
            "attest_exact": {"back_half": 2 * attest_frames},
            # one warm-up step, RECORDED live, RECORDED replayed against
            # them, then the timed replays; two K1 launches and one K10
            # a step
            "serving_at_size": {"fused_granule": 2 * at_size_steps,
                                "l3_expand": at_size_steps},
            "single_core": {}, "parse": {}, "l12": {"l12_synth": short}}
    by = line["launches"]["by_measurement"]
    for name, w in want.items():
        check(by[name] == w, f"phase 33: {name} launched {by[name]}, "
                             f"want {w}")
    for name, kernels in (("e2e_ab", ["fused_granule", "l3_expand"]),
                          ("drain_ab", ["fused_granule", "l3_expand"]),
                          ("e2e_lsf", ["fused_granule_lsf"])):
        check(sorted(by[name]) == kernels and all(by[name].values()),
              f"phase 33: {name} launched {by[name]}")
    check(line["kernel_exact_bitexact_vs_split_on_gpu"] is True
          and line["kernel_fast_max_lsb_vs_split_on_gpu"] <= MAX_LSB
          and line["exact_bitexact_vs_native_on_gpu"] is True
          and line["serving_at_size"]["replay_matches_live"] is True,
          f"phase 33: attestation failed: {json.dumps(line)}")
    ref = line["exact_bitexact_vs_reference_on_gpu"]
    check((ref is True) if line["reference_status"] == "built"
          else (ref is None and line["reference_status"].startswith(
              "not built: ")), f"phase 33: reference {ref}, "
                               f"{line['reference_status']}")
    rates = [line[k] for k in BENCH_RATE_KEYS]
    rates += list(line["kernel_sweep_rtf"].values())
    rates += [v for k, v in line["serving_at_size"].items()
              if k != "replay_matches_live"]
    check(all(
        isinstance(x, (int, float)) and math.isfinite(x) and x > 0
        for x in rates), f"phase 33: a rate is not finite and positive: "
                         f"{json.dumps(line)}")
    return line


def phase_correctness(pcm: np.ndarray, watch: list[int],
                      specs: list[tuple[bytes, dict]],
                      exact: bool = False) -> list[dict]:
    """Each watched slot's PCM against the native scalar decoder (with
    PROFILE_LSF for LSF streams, PROFILE_L12 for Layer I/II ones) over
    the aligned prefix (the slot keeps decoding its looping stream):
    bitwise when exact, else the fast contract."""
    from pdmp3_tpu_torch.host import (PROFILE_L12, PROFILE_LSF,
                                      native_decode_file)

    out = []
    for row, slot in enumerate(watch):
        data, spec = specs[slot % len(specs)]
        profile = (PROFILE_LSF if spec.get("family") else 0) | (
            PROFILE_L12 if spec.get("layer") else 0)
        want = np.frombuffer(native_decode_file(data, profile=profile),
                             "<i2")
        got = pcm[row]
        got = got[:, 0] if spec["mode"] == 3 else got.reshape(-1)
        check(len(want) > 0 and len(got) >= len(want),
              f"slot {slot}: {len(got)} samples for {len(want)} native")
        d = np.abs(got[:len(want)].astype(np.int32) - want.astype(np.int32))
        lsb, frac = int(d.max()), float((d != 0).mean())
        out.append({"slot": slot, "blocks": spec.get("blocks"),
                    "layer": spec.get("layer", 3), "mode": spec["mode"],
                    "mode_extension": spec.get("mode_extension", 0),
                    "sfreq": spec["sfreq"], "samples": int(len(want)),
                    "max_lsb": lsb, "frac_differing": frac})
        check(lsb == 0 if exact else lsb <= MAX_LSB and frac < MAX_FRAC,
              f"slot {slot} (exact={exact}): {lsb} LSB on {frac:.4%} vs "
              "native")
    return out


def watched_slots(specs: list[tuple[bytes, dict]], want=None) -> list[int]:
    """One slot per (key, value) feature of `want` the phase must cover
    (default: blocks, stereo modes and sample rates of Layer III)."""
    want = want or [("blocks", "long"), ("blocks", "short"),
                    ("blocks", "mixed"), ("blocks", "varied"),
                    ("mode_extension", 2), ("mode_extension", 3),
                    ("mode", 3), ("sfreq", 1), ("sfreq", 2)]
    slots = []
    for key, val in want:
        slots.append(next(i for i, (_, s) in enumerate(specs)
                          if s.get(key) == val and i not in slots))
    return slots


def launch_line(launch: dict, ptxas: list[str], kernel: str) -> str:
    """One line of a persistent kernel's geometry: the library's launch
    info and ptxas's registers / spills / shared memory of `kernel`."""
    rep = next((p.split(": ", 1)[1] for p in ptxas
                if p.startswith(kernel + ":")), "no ptxas report")
    return (f"grid {launch['grid']} ({launch['sm_count']} SMs x "
            f"{launch['blocks_per_sm']} blocks), "
            f"{launch['dynamic_smem_bytes']} B dynamic shared memory per "
            f"block, {launch['registers']} registers, "
            f"{launch['local_bytes']} B local per thread; ptxas: {rep}")


_LAP = [0.0]


def lap(name: str) -> None:
    """Record the wall seconds since the last lap as phase `name`'s."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = now - _LAP[0]
    _LAP[0] = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 13: torch.profiler over serving steps "
                         "and a parse-thread sweep")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from pdmp3_tpu_torch import device
    from pdmp3_tpu_torch import tables as T

    dev = device.require_cuda()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = _LAP[0] = time.perf_counter()
    from pdmp3_tpu_torch.host import build as host_build
    from pdmp3_tpu_torch.ops import _build
    host_build.ensure_built()
    t1 = time.perf_counter()
    _build.ensure_built()
    with open(_build.LOG) as f:
        ptxas = _build.ptxas_summary(f.read())
    print(f"host library build {t1 - t0:.1f} s; kernel build "
          f"{time.perf_counter() - t1:.1f} s; " + " | ".join(ptxas))
    lap("build")

    t0 = time.perf_counter()
    specs = corpus()
    streams = [s for s, _ in specs]
    print(f"corpus: {len(streams)} streams x {FRAMES_PER_STREAM} frames "
          f"in {time.perf_counter() - t0:.1f} s")
    fr = parsed_frame(streams, dev)
    lap("corpus")

    k10 = phase_k10(streams, dev)
    print("phase 37 K10 vs plain:", json.dumps(k10))
    print("phase 37 K10 ptxas:", next(
        (p for p in ptxas if p.startswith("widen_lines_kernel:")),
        "no ptxas report"))
    lap("phase 37")

    k1 = phase_kernel(fr, exact=False)
    print("phase 2 K1 vs plain:", json.dumps(k1))
    print("phase 2 K1 launch:", launch_line(k1["launch"], ptxas,
                                            "fused_granule_kernel<false>"))
    lap("phase 2")

    watch = watched_slots(specs)
    m = phase_main_path(streams, dev, watch)
    print("phase 3 main path:",
          json.dumps({k: v for k, v in m.items() if k != "_pcm"}))
    slots = phase_correctness(m["_pcm"], watch, specs)
    print("phase 4 vs native:", json.dumps(slots))
    lap("phases 3-4")

    k2 = phase_kernel(fr, exact=True)
    print("phase 5 K2 vs plain:", json.dumps(k2))
    print("phase 5 K2 launch:", launch_line(k2["launch"], ptxas,
                                            "fused_granule_kernel<true>"))
    lap("phase 5")

    me = phase_main_path(streams, dev, watch, exact=True)
    exact_pcm = me.pop("_pcm")
    slots = phase_correctness(exact_pcm, watch, specs, exact=True)
    me["exact_over_fast_step_ms"] = me["exact_step_ms"] / m["step_ms"]
    print("phase 6 exact main path:", json.dumps(me))
    print("phase 6 vs native (bitwise):", json.dumps(slots))
    lap("phase 6")

    k4 = phase_back_half(fr)
    print("phase 7 K4 vs plain, fused vs split:", json.dumps(k4))
    for exact in (True, False):
        print(f"phase 7 K4 exact={exact} launch:", launch_line(
            k4["exact" if exact else "fast"]["launch"], ptxas,
            f"back_half_kernel<{str(exact).lower()},"
            f"{str(not exact).lower()}>"))
    lap("phase 7")
    k4r = phase_k4_raw(fr)
    print("phase 17 K4 fast raw sums vs plain:", json.dumps(k4r))
    print("phase 17 K4 fast raw sums launch:", launch_line(
        k4r["launch"], ptxas, "back_half_kernel<false,false>"))
    lap("phase 17 kernel")
    kf = {}
    for exact in (False, True):
        kf[(0, exact)] = r = phase_float_kernel(fr, exact)
        print(f"phase 34 float instance MPEG-1 exact={exact} vs plain:",
              json.dumps(r))
        print(f"phase 34 float instance MPEG-1 exact={exact} launch:",
              launch_line(r["launch"], ptxas, "fused_granule_float_kernel"
                          f"<{str(exact).lower()}>"))
    lap("phase 34 MPEG-1")
    k5 = {0: phase_frame_kernel(fr)}
    print("phase 14 K5 MPEG-1 vs plain, vs two K1:", json.dumps(k5[0]))
    print("phase 14 K5 MPEG-1 launch:", launch_line(
        k5[0]["launch"], ptxas, "frame_fused_kernel<false>"))
    del fr
    lap("phase 14 MPEG-1")

    api = phase_api(dev)
    print("phase 8 TorchDSP decode_file:", json.dumps(api))
    lap("phase 8")

    k6 = phase_sweep(dev)
    print("phase 9 K6 sweep:", json.dumps(k6))
    lap("phase 9")

    k3, lsf_serving, lsf_specs = {}, {}, {}
    for family in LSF_FAMILIES:
        t0 = time.perf_counter()
        lspecs = lsf_specs[family] = lsf_corpus(family)
        lstreams = [s for s, _ in lspecs]
        print(f"LSF family {family} corpus: {len(lstreams)} streams x "
              f"{FRAMES_PER_STREAM} frames in "
              f"{time.perf_counter() - t0:.1f} s")
        lfr = parsed_frame(lstreams, dev, family)
        for exact in (False, True):
            r = phase_kernel(lfr, exact, family)
            k3[(family, exact)] = r
            print(f"phase 10 K3 family {family} exact={exact} vs plain:",
                  json.dumps(r))
            print(f"phase 10 K3 family {family} exact={exact} launch:",
                  launch_line(r["launch"], ptxas, "fused_granule_lsf_kernel"
                              f"<{str(exact).lower()}>"))
        for exact in (False, True):
            kf[(family, exact)] = r = phase_float_kernel(lfr, exact, family)
            print(f"phase 34 float instance family {family} exact={exact} "
                  "vs plain:", json.dumps(r))
            print(f"phase 34 float instance family {family} exact={exact} "
                  "launch:", launch_line(
                      r["launch"], ptxas, "fused_granule_lsf_float_kernel"
                      f"<{str(exact).lower()}>"))
        k5[family] = phase_frame_kernel(lfr, family)
        print(f"phase 14 K5 family {family} vs plain:",
              json.dumps(k5[family]))
        print(f"phase 14 K5 family {family} launch:", launch_line(
            k5[family]["launch"], ptxas, "frame_fused_kernel<true>"))
        del lfr
        lwatch = watched_slots(lspecs)
        rates = [int(T.SAMPLE_RATES_FAM[family][sp["sfreq"]])
                 for _, sp in lspecs]
        for exact in (False, True):
            r = phase_main_path(lstreams, dev, lwatch, exact, family, rates)
            slots = phase_correctness(r.pop("_pcm"), lwatch, lspecs, exact)
            lsf_serving[(family, exact)] = r
            print(f"phase 11 LSF family {family} exact={exact} serving:",
                  json.dumps(r))
            print(f"phase 11 vs native ({'bitwise' if exact else 'fast'}):",
                  json.dumps(slots))
        lap(f"phases 10, 11, 14, 34 family {family}")
    api_lsf = phase_api(dev, lsf=True)
    print("phase 12 TorchDSP decode_file on LSF:", json.dumps(api_lsf))
    lap("phase 12")
    mf = phase_main_path(streams, dev, watch, frame_fused=True)
    check(np.array_equal(mf.pop("_pcm"), m["_pcm"]),
          "phase 15: frame-fused PCM differs from phase 3's")
    mf["ff_over_per_granule_step_ms"] = mf["ff_step_ms"] / m["step_ms"]
    mf["ff_over_per_granule_loop_ms"] = (mf["ff_loop_ms_per_step"]
                                         / m["loop_ms_per_step"])
    mf["replay_ab_interleaved"] = replay_ab(streams, dev)
    print("phase 15 frame-fused serving:", json.dumps(mf))
    lap("phase 15")
    sp = phase_sparse(streams, dev, watch, m["_pcm"])
    print("phase 16 sparse frame-fused pipelined serving:", json.dumps(sp))
    lap("phase 16")
    fp = phase_float_pcm(streams, dev, watch,
                         {False: m["_pcm"], True: exact_pcm})
    print("phase 17 float PCM serving:", json.dumps(fp))
    lap("phase 17 routes")
    l12_frames = {layer: l12_frame(layer, dev) for layer in L12_S}
    k9 = phase_k9(dev, l12_frames)
    for layer, r in k9.items():
        print(f"phase 35 K9 layer {layer} vs plain:", json.dumps(r))
        print(f"phase 35 K9 layer {layer} ptxas:", next(
            (p for p in ptxas
             if p.startswith(f"subband_requant_kernel<{L12_S[layer]}>")),
            "no ptxas report"))
    k7 = phase_k7(dev, l12_frames)
    del l12_frames
    for (layer, name), r in k7.items():
        print(f"phase 35 K7 layer {layer} {name} vs plain:", json.dumps(r))
        print(f"phase 35 K7 layer {layer} {name} launch:", launch_line(
            r["launch"], ptxas, "subband_synth_kernel<{},{},{}>".format(
                str("exact" in name).lower(), str("float" in name).lower(),
                L12_S[layer])))
    lap("phase 35")
    k8 = phase_k8(dev)
    print("phase 36 K8 vs plain:", json.dumps(k8))
    lap("phase 36")
    l12 = phase_l12(dev)
    print("phase 18 Layer I/II pools:", json.dumps(l12))
    lap("phase 18")
    joins = phase_join(streams, dev)
    print("phase 19 mid-stream joins:", json.dumps(joins))
    lap("phase 19")
    rs = phase_resample(dev)
    print("phase 20 resampler:", json.dumps(rs))
    lap("phase 20")
    files = phase_files(specs, dev)
    print("phase 21 file decode:", json.dumps(files))
    lap("phase 21")
    sh = phase_sharded(specs, lsf_specs[1], dev, watch)
    print("phase 22 sharded serving:", json.dumps(sh))
    lap("phase 22")
    rk = phase_ranks(specs, watch, dev)
    print("phase 23 two processes on one card:", json.dumps(rk))
    lap("phase 23")
    en = phase_entry(dev)
    print("phase 24 entry step and dry run:", json.dumps(en))
    lap("phase 24")
    sd = phase_serving_diff(dev)
    print("phase 25 serving diff:", json.dumps(sd))
    lap("phase 25")
    sc = phase_scale_sim(dev)
    print("phase 26 scale simulation:", json.dumps(sc))
    lap("phase 26")
    wp = phase_wire_profile(streams, dev)
    print("phase 27 wire profile:", json.dumps(wp))
    lap("phase 27")
    mh = phase_multihost_soak()
    print("phase 28 multi-process soak:", json.dumps(mh))
    lap("phase 28")
    ps = phase_parse_scaling(dev, k1["kernel_ms"])
    print("phase 29 parse scaling:", json.dumps(ps))
    lap("phase 29")
    rsw = phase_resample_sweep(dev)
    print("phase 30 resample sweep:", json.dumps(rsw))
    lap("phase 30")
    so = phase_soak(dev)
    print("phase 31 soak:", json.dumps(so))
    lap("phase 31")
    lf = {}
    for family in LSF_FAMILIES:
        lf[family] = phase_lsf_float_pcm(lsf_specs[family], dev, family)
        print(f"phase 32 LSF float PCM family {family}:",
              json.dumps(lf[family]))
    lap("phase 32")
    bn = phase_bench(dev)
    print("phase 33 bench:", json.dumps(bn))
    lap("phase 33")
    # phase 33's launches of K1, K2, K3 (fast) and K4 (instances 6, 7)
    bench_k = bn["launches"]["total"]
    # phase 32's K4 launches (instance 7 exact, 8 fast)
    lf_k4 = {exact: sum(lf[f]["exact" if exact else "fast"]["launches"][
        "back_half" if exact else "back_half_raw"] for f in LSF_FAMILIES)
        for exact in (True, False)}
    # phases 25-31's launches of K1, K2 and K4
    tools_k1 = sum(r["launches"].get("fused_granule", 0)
                   for r in (sd, sc, wp))
    tools_k2 = (sd["launches"]["fused_granule_exact"]
                + mh["launches"]["fused_granule_exact"])
    tools_k4 = so["launches"]["back_half"]
    # phases 22-24's launches of K1, K2 and K3
    more = {
        "fused_granule": sum(sh["mpeg1_fast"]["launches"].values())
        + sh["clipped"]["launches"] + en["entry_k1_launches"]
        + en["dryrun_launches"]["fused_granule"],
        "fused_granule_exact": sum(sh["mpeg1_exact"]["launches"].values())
        + sum(r["launches"] for r in rk["ranks"]),
        "fused_granule_lsf": en["dryrun_launches"]["fused_granule_lsf"],
        "fused_granule_lsf_exact":
        sum(sh["mpeg2_exact"]["launches"].values())}
    if args.profile:
        print("phase 13 profile:", json.dumps(phase_profile(streams, dev)))
        lap("phase 13")
    print("phase wall seconds:", json.dumps(
        {**PHASE_SECONDS, "total": sum(PHASE_SECONDS.values())}))
    check("jax" not in sys.modules, "JAX was imported")
    check(not [m for m in sys.modules if m.split(".")[0] == "pdmp3_tpu"],
          "the JAX package was imported")

    def entry(name, src, launches, err, t, bnd, **extra):
        """One kernel's record; t: its phase result (kernel_timing's
        keys and plain_ms)."""
        return {"name": name, "route": "cuda", "source": CSRC + src,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": err, "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bnd["bound_ms"],
                "bound_by": bnd["bound_by"], "library_ms": None,
                "burst_ms": t["kernel_burst_ms"],
                "per_call_ms": t["kernel_per_call_ms"], **extra}

    def lsf_entry(exact):
        name = "fused_granule_lsf" + ("_exact" if exact else "")
        pre = "exact_" if exact else ""
        by_family = {
            f: lsf_serving[(f, exact)][f"{pre}lsf{f}_kernel_launches"]
            for f in LSF_FAMILIES}
        r1 = k3[(1, exact)]
        # phase 32's pools decode every step with K3 beside the float route
        beside = sum(lf[f]["exact" if exact else "fast"]["launches"][name]
                     for f in LSF_FAMILIES)
        return entry(name, "fused_granule.cu",
                     sum(by_family.values()) + more[name] + beside
                     + bench_k.get(name, 0),
                     max(k3[(f, exact)]["pcm_max_lsb"]
                         for f in LSF_FAMILIES), r1, r1,
                     launch=r1["launch"], launches_by_family=by_family,
                     launches_phases_22_24=more[name],
                     launches_phase_32=beside,
                     launches_phase_33=bench_k.get(name, 0),
                     ms_by_family={f: k3[(f, exact)]["kernel_ms"]
                                   for f in LSF_FAMILIES},
                     plain_ms_by_family={f: k3[(f, exact)]["plain_ms"]
                                         for f in LSF_FAMILIES})

    def float_entry(family, exact):
        """Instances 9-12: the MPEG-1 ones launched by phase 17's pools,
        the LSF ones by phase 32's float route, one family each."""
        name = ("fused_granule" + ("_lsf" if family else "") + "_float"
                + ("_exact" if exact else ""))
        mode = "exact" if exact else "fast"
        fams = LSF_FAMILIES if family else (0,)
        if family:
            by_path = {f"lsf_float_pcm_phase_32_family_{f}":
                       lf[f][mode]["launches"][name] for f in fams}
        else:
            by_path = {"float_pcm_serving_phase_17":
                       fp[mode][("exact_" if exact else "")
                                + "float_kernel_launches"]}
        r = kf[(fams[0], exact)]
        return entry(name, "fused_granule.cu", sum(by_path.values()),
                     max(kf[(f, exact)]["pcm_max_abs_err"] for f in fams),
                     r, r, instance=9 + 2 * (family != 0) + exact,
                     launch=r["launch"], launches_by_path=by_path,
                     ms_by_family={f: kf[(f, exact)]["kernel_ms"]
                                   for f in fams},
                     plain_ms_by_family={f: kf[(f, exact)]["plain_ms"]
                                         for f in fams},
                     ragged=r["ragged"]["batch_slots"])

    def k7_entry(exact, float_pcm):
        """K7's instances of one precision and PCM type (the Layer II
        instance's times and bound, Layer I's beside them), launched by
        phase 18's pools, the dry run (24), Layer II files (21), the
        sharded Layer II pools (22) and the bench (33)."""
        name = l12_kernel(exact, float_pcm)
        mode = "exact" if exact else "fast"
        pools = ([f"layer2_{mode}_float"] if float_pcm
                 else [f"layer1_{mode}", f"layer2_{mode}"])
        by_path = {f"l12_pools_phase_18_{p}": l12[p]["kernel_launches"]
                   for p in pools}
        if name == "l12_synth":
            by_path["dryrun_phase_24"] = en["dryrun_launches"][name]
            by_path["bench_phase_33"] = bench_k.get(name, 0)
        if name == "l12_synth_exact":
            by_path["layer2_files_phase_21"] = files["batched_layer2"][
                "kernel_launches"]
            by_path["sharded_layer2_phase_22"] = sum(
                sh["layer2_exact"]["launches"].values())
        r2, r1 = k7[(2, name)], k7[(1, name)]
        return entry(name, "l12_synth.cu", sum(by_path.values()),
                     max(r[k]["max_abs_err"] if k else r["max_abs_err"]
                         for r in (r1, r2)
                         for k in (None, "nan_inf_state",
                                   "subnormal_samples", "mirror_hazards")),
                     r2, r2, launches_by_path=by_path,
                     launch={"layer1": r1["launch"], "layer2": r2["launch"]},
                     layer1={"ms": r1["kernel_ms"],
                             "burst_ms": r1["kernel_burst_ms"],
                             "per_call_ms": r1["kernel_per_call_ms"],
                             "plain_ms": r1["plain_ms"],
                             "bound_ms": r1["bound_ms"],
                             "bound_by": r1["bound_by"]},
                     ragged={layer: [x["batch_slots"] for x in
                                     k7[(layer, name)]["ragged"]]
                             for layer in L12_S})

    def k4_times(r):
        return {"ms": r["kernel_ms"], "burst_ms": r["kernel_burst_ms"],
                "per_call_ms": r["kernel_per_call_ms"],
                "plain_ms": r["plain_ms"]}
    # K9: once a step of every Layer I/II pool, as often as its K7
    k9_paths = {f"l12_pools_phase_18_{p}": r["kernel_launches"]
                for p, r in l12.items() if isinstance(r, dict)}
    k9_paths["layer2_files_phase_21"] = files["batched_layer2"][
        "kernel_launches"]
    k9_paths["sharded_layer2_phase_22"] = sum(
        sh["layer2_exact"]["launches"].values())
    # K10: once a step of every MPEG-1 pool; this process's launches
    # (every phase's, kept across the resets) and the spawned ranks'
    reset_launch_counts()
    k10_paths = {"this_process": LAUNCH_TOTALS["l3_expand"],
                 "ranks_phase_23": sum(r["launches"] // 2
                                       for r in rk["ranks"]),
                 "soak_ranks_phase_28": sum(r["launches"]["l3_expand"]
                                            for r in mh["ranks"])}
    k4e, k4f = k4["exact"], k4["fast"]
    print(json.dumps({"kernels": [
        entry("fused_granule", "fused_granule.cu",
              m["kernel_launches"] + more["fused_granule"] + tools_k1
              + bench_k["fused_granule"],
              k1["pcm_max_lsb"], k1, k1, launch=k1["launch"],
              launches_phases_22_24=more["fused_granule"],
              launches_phases_25_31=tools_k1,
              launches_phase_33=bench_k["fused_granule"],
              k5_ng1_ms=k5[0]["ng1_ab_interleaved"]["k5_ng1_ms"],
              k1_over_k5_ng1=k5[0]["ng1_ab_interleaved"]["k1_over_k5_ng1"]),
        entry("fused_granule_exact", "fused_granule.cu",
              me["exact_kernel_launches"] + more["fused_granule_exact"]
              + tools_k2 + bench_k["fused_granule_exact"],
              k2["pcm_max_lsb"], k2, k2, launch=k2["launch"],
              launches_phases_22_24=more["fused_granule_exact"],
              launches_phases_25_31=tools_k2,
              launches_phase_33=bench_k["fused_granule_exact"]),
        lsf_entry(False),
        lsf_entry(True),
        entry("back_half", "back_half.cu",
              api["k4_launches"]
              + fp["exact"]["exact_float_split_k4_launches"]
              + tools_k4 + lf_k4[True] + bench_k["back_half"],
              max(k4e["max_abs_err"], k4f["max_abs_err"],
                  *(lf[f]["exact"]["k4"]["max_abs_err"]
                    for f in LSF_FAMILIES)), k4e, k4,
              launches_by_path={
                  "per_stream_decode_file": api["k4_launches"],
                  "float_pcm_exact_split_check_phase_17":
                  fp["exact"]["exact_float_split_k4_launches"],
                  "soak_torch_dsp_phase_31": tools_k4,
                  "lsf_float_pcm_phase_32": lf_k4[True],
                  "bench_phase_33": bench_k["back_half"]},
              ms_lsf_by_family={f: lf[f]["exact"]["k4"]["kernel_ms"]
                                for f in LSF_FAMILIES},
              ms_fast=k4f["kernel_ms"],
              burst_ms_fast=k4f["kernel_burst_ms"],
              per_call_ms_fast=k4f["kernel_per_call_ms"],
              plain_ms_fast=k4f["plain_ms"],
              launch={"exact": k4e["launch"], "fast": k4f["launch"]},
              one_slot={"exact": k4_times(k4e["one_slot"]),
                        "fast": k4_times(k4f["one_slot"]),
                        **k4["one_slot_bound"]},
              split_step_ms={"exact": k4e["split_step_ms"],
                             "fast": k4f["split_step_ms"]}),
        entry("back_half_raw", "back_half.cu",
              fp["fast"]["float_split_k4_launches"] + lf_k4[False],
              max(k4r["max_abs_err"], *(lf[f]["fast"]["k4"]["max_abs_err"]
                                        for f in LSF_FAMILIES)), k4r,
              k4r, instance=8, launch=k4r["launch"],
              launches_by_path={
                  "float_pcm_fast_split_check_phase_17":
                  fp["fast"]["float_split_k4_launches"],
                  "lsf_float_pcm_phase_32": lf_k4[False]},
              ms_lsf_by_family={f: lf[f]["fast"]["k4"]["kernel_ms"]
                                for f in LSF_FAMILIES},
              one_slot={**k4_times(k4r["one_slot"]),
                        **k4r["one_slot_bound"]},
              ragged=k4r["ragged"]["batch_slots"]),
        entry("rounding_sweep", "rounding_sweep.cu", k6["launches"],
              k6["max_abs_err"], k6,
              sweep_bound(k6["chunk_inputs"], len(k6["constructions"])),
              plain_ms_by_construction=k6["plain_ms_by_construction"],
              sweep_seconds=k6["seconds"]),
        entry("frame_fused", "frame_fused.cu",
              mf["ff_kernel_launches"] + sp["k5_launches"],
              max(r["pcm_max_lsb"] for r in k5.values()), k5[0], k5[0],
              ng=2, launch=k5[0]["launch"],
              launches_by_family={0: mf["ff_kernel_launches"]
                                  + sp["k5_launches"], 1: 0, 2: 0},
              ms_by_family={f: r["kernel_ms"] for f, r in k5.items()},
              plain_ms_by_family={f: r["plain_ms"] for f, r in k5.items()},
              two_k1_ms=k5[0]["ab_interleaved"]["two_k1_ms"],
              k5_over_two_k1=k5[0]["ab_interleaved"]["k5_over_two_k1"]),
        *(float_entry(family, exact) for family in (0, 1)
          for exact in (False, True)),
        *(k7_entry(exact, float_pcm) for float_pcm in (False, True)
          for exact in (False, True)),
        entry("l12_requant", "l12_requant.cu", sum(k9_paths.values()),
              max(r["max_abs_err"] for r in k9.values()), k9[2], k9[2],
              launches_by_path=k9_paths,
              layer1={k: k9[1][k] for k in ("kernel_ms", "kernel_burst_ms",
                                            "kernel_per_call_ms", "plain_ms",
                                            "bound_ms", "bound_by")}),
        entry("l3_expand", "l3_expand.cu", sum(k10_paths.values()),
              k10["max_abs_err"], k10["lame"], k10["lame"],
              launches_by_path=k10_paths, shape={"batch_slots": BENCH_SLOTS,
                                                 "escapes":
                                                 k10["lame"]["escapes"]},
              at_b={k: k10["corpus"][k] for k in (
                  "slots", "escapes", "kernel_ms", "kernel_burst_ms",
                  "kernel_per_call_ms", "plain_ms", "bound_ms",
                  "share_of_bound")}),
        entry("resample", "resample.cu", rs["k8_launches"] + rsw["blocks"],
              k8["max_abs_err"], k8, k8,
              launches_by_path={"resampled_pool_phase_20": rs["k8_launches"],
                                "resample_sweep_phase_30": rsw["blocks"]},
              shape={"batch_slots": B, "block": k8["block"],
                     "n_out": k8["n_out"], "channels": 2,
                     "pair": list(RESAMPLE_PAIR)}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
