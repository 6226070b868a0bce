#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

MPEG-1 Layer III decoding through ``pdmp3_tpu_torch`` at B = 8192
stream slots, fast and exact, in nine phases; any failure exits
non-zero.  The kernels are built here from ``pdmp3_tpu_torch/csrc``.

1. the card's name and power limit, then a check that CUDA is visible;
2. K1, the fast granule kernel, against its plain PyTorch version on the
   same CUDA tensors: one frame (two granule steps) of natively parsed
   wire, a few idle slots, a random starting state; both timed;
3. the fast main path: ``StreamDecoder(8192, device="cuda")`` fed by
   ``LoopFeeder`` from 64 distinct generated streams, 2 warm-up and 32
   timed frame steps of feed -> parse_step -> decode_step, with K1's
   launch count checked against the steps run;
4. the PCM of slots covering long, short, mixed, MS, intensity, mono,
   32 and 48 kHz streams against the native scalar C++ decoder;
5. K2, the exact granule kernel, against its plain version as in phase
   2, and on a directed granule whose band-12 carry holds subnormal bit
   patterns (denormal band-12 gains); bitwise, both timed;
6. the exact main path: phase 3 with ``exact=True`` (K2), and its
   watched slots bitwise equal to the native decoder;
7. K4, the back-half kernel, against its plain version in both modes on
   one frame's post-antialias spectra, bitwise and timed; then the fused
   exact route (K2) against the split one (stage ops + K4 + the f64
   quantize), bitwise;
8. the per-stream route: ``pdmp3_tpu.api.decode_file`` with
   ``TorchDSP(device="cuda")`` (K4) on 6 generated streams, exact
   byte-equal to the native decoder and fast within 1 LSB;
9. K6: the exact kernel's three float64 rounding points over all 2^32
   f32 inputs on the card against their plain f64 versions, bitwise.

    python3 chip_smoke.py --profile

adds a tenth phase: ``torch.profiler`` over fast serving steps (device
time by kernel and copy, and the device's busy share of the loop), then
the serving loop at 1, 2, 4 and 8 parse threads.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

B = 8192
N_STREAMS = 64
FRAMES_PER_STREAM = 12
WARMUP_STEPS = 2
TIMED_STEPS = 32
TIMED_LAUNCHES = 25
PROFILE_STEPS = 8
PARSE_THREADS = (1, 2, 4, 8, 8, 4, 2, 1)   # two passes, mirrored
SWEEP_STEPS = 16
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
            "back_half": "pdmp3_tpu/ops/pallas_step.py:463",
            "rounding_sweep": "tools/prove_on_tpu.py:88"}
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
SWEEP_TIMED = 9      # chunk launches timed for K6's ms / plain_ms


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _counters() -> dict:
    """kernel name -> (module, attribute) of its wrapper's launch count."""
    from pdmp3_tpu_torch.ops import back_half as BH
    from pdmp3_tpu_torch.ops import fused_step as FS
    from pdmp3_tpu_torch.ops import rounding as R
    return {"fused_granule": (FS, "LAUNCHES"),
            "fused_granule_exact": (FS, "LAUNCHES_EXACT"),
            "back_half": (BH, "LAUNCHES"),
            "rounding_sweep": (R, "LAUNCHES")}


def reset_launch_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def launch_counts(path: str, kernel: str) -> int:
    """The launches of `kernel` since the last reset; every other kernel
    must have launched no time on the path."""
    counts = {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}
    others = {k: n for k, n in counts.items() if k != kernel and n}
    check(not others, f"{path}: launched {others} beside {kernel}")
    return counts[kernel]


def corpus() -> list[tuple[bytes, dict]]:
    """64 distinct 12-frame streams in bench.py's serving mix (blocks,
    mode, bitrate, sample rate, reservoir), with the joint-stereo
    streams carrying MS (mode_extension 2) or MS + intensity (3) so that
    both stereo paths run."""
    from pdmp3_tpu.testing import mp3gen

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


def median_ms(fn, n: int) -> float:
    """Median over n calls of fn's device time, from CUDA events."""
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def clone_state(s):
    from pdmp3_tpu_torch.models.decoder import DecoderState
    return DecoderState(s.store.clone(), s.v_blocks.clone(),
                        s.prev_lines.clone())


def pcm_error(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), float((d != 0).float().mean())


def parsed_frame(streams: list[bytes], dev) -> dict:
    """One natively parsed frame of wire for B slots on the card (the
    INACTIVE slots idle) and a random starting state."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.models.decoder import DecoderState, wire_sections

    dec = StreamDecoder(B, device=dev)
    LoopFeeder(dec, streams).step()
    check(dec.parse_step() == B, "not every slot parsed a frame")
    w = wire_sections(torch.from_numpy(dec.wire.copy()).to(dev), B)
    del dec
    active = w["active"].to(torch.int32)
    active[list(INACTIVE)] = 0
    rng = np.random.default_rng(0)
    st0 = DecoderState(*(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
        for shape in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))
    return {"ix": w["ix"], "scf_l": w["scf_l"], "scf_s": w["scf_s"],
            "meta": w["meta"].to(torch.int32), "active": active,
            "st0": st0}


def granule_args(fr: dict, gr: int) -> tuple:
    return (fr["ix"][gr], fr["scf_l"][gr], fr["scf_s"][gr],
            fr["meta"][gr].contiguous(), fr["active"], gr)


def compare_steps(fr: dict, step_k, step_r, phase: str, grs=(0, 1),
                  st0=None) -> dict:
    """Run the granules grs with a kernel step and its plain version from
    the same state; require PCM and state bitwise equal and the idle
    slots silent and frozen."""
    st0 = fr["st0"] if st0 is None else st0

    def run(step, state):
        outs = []
        for gr in grs:
            pcm, state = step(*granule_args(fr, gr), state)
            outs.append(pcm)
        return torch.cat(outs, 1), state

    pk, sk = run(step_k, clone_state(st0))
    pr, sr = run(step_r, clone_state(st0))
    torch.cuda.synchronize()
    lsb, frac = pcm_error(pk, pr)
    res = {"tolerance": "bitwise (PCM, store, v, prev_lines); reported: "
                        f"PCM <= {MAX_LSB} LSB on < {MAX_FRAC:.0%} of "
                        f"samples, store/v/prev <= {STATE_RTOL} x "
                        "max(1, max|plain|)",
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
    for s in INACTIVE:
        check(not bool(pk[s].any()), f"{phase}: idle slot {s} has PCM")
        for name in ("store", "v_blocks", "prev_lines"):
            check(torch.equal(getattr(sk, name)[s].view(torch.int32),
                              getattr(st0, name)[s].view(torch.int32)),
                  f"{phase}: idle slot {s} {name} changed")
    check(bool(pk[0].any()), f"{phase}: active slot 0 is silent")
    return res


def phase_kernel(fr: dict, exact: bool) -> dict:
    """The fused kernel (K1, or K2 when exact) vs its plain version on
    one natively parsed frame; both timed per granule step."""
    from pdmp3_tpu_torch.ops import fused_step as FS

    phase = "phase 5" if exact else "phase 2"
    step_k = functools.partial(FS.fused_granule_step, exact=exact)
    step_r = functools.partial(FS.fused_granule_step_ref, exact=exact)
    res = compare_steps(fr, step_k, step_r, phase)
    if exact:
        res["band12_subnormal"] = phase_band12_subnormal(fr, step_k,
                                                         step_r)
    # one granule step per timed call, each on its own state copy
    sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
    args = granule_args(fr, 0)
    res["kernel_ms"] = median_ms(lambda: step_k(*args, sk), TIMED_LAUNCHES)
    res["plain_ms"] = median_ms(lambda: step_r(*args, sr), TIMED_LAUNCHES)
    return res


def phase_band12_subnormal(fr: dict, step_k, step_r) -> dict:
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
                        "phase 5 band-12 subnormal", grs=(1,), st0=st0)
    f = D.fields(fr["meta"][1])
    q = (2 << f.scalefac_scale[:, 1:2].long()) * bits.reshape(B, 3)
    short1 = f.layout[:, 1] % 3 != 0
    hit = short1 & (fr["active"] != 0) & ((q >= 504) & (q < 600)).any(1)
    res["slots_with_subnormal_band12_gain"] = int(hit.sum())
    check(res["slots_with_subnormal_band12_gain"] > 0,
          "phase 5: no slot reached a subnormal band-12 gain")
    return res


def phase_back_half(fr: dict) -> dict:
    """K4 vs its plain version, exact and fast, on the post-antialias
    spectra of granule 0, bitwise and timed; then the fused exact route
    (K2) vs the split one (stage ops + K4 + f64 quantize), bitwise."""
    from pdmp3_tpu_torch.ops import back_half as BH
    from pdmp3_tpu_torch.ops import dsp as D
    from pdmp3_tpu_torch.ops import fused_step as FS

    args = granule_args(fr, 0)
    f = D.fields(args[3])
    bt = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    res = {}
    for exact in (True, False):
        mode = "exact" if exact else "fast"
        xa = D.front_half(*args[:4], 0, fr["st0"].prev_lines, exact)
        sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
        ok, pk = BH.back_half_step(xa, sk, bt, fr["active"], exact)
        orf, pr = BH.back_half_step_ref(xa, sr, bt, fr["active"], exact)
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
                  f"phase 7: K4 {mode} {name} differs from the plain "
                  "version")
        sk, sr = clone_state(fr["st0"]), clone_state(fr["st0"])
        r["kernel_ms"] = median_ms(
            lambda: BH.back_half_step(xa, sk, bt, fr["active"], exact),
            TIMED_LAUNCHES)
        r["plain_ms"] = median_ms(
            lambda: BH.back_half_step_ref(xa, sr, bt, fr["active"], exact),
            TIMED_LAUNCHES)
        res[mode] = r
    res["fused_vs_split"] = compare_steps(
        fr, functools.partial(FS.fused_granule_step, exact=True),
        functools.partial(BH.split_granule_step, exact=True),
        "phase 7 fused vs split")
    return res


def phase_api(dev) -> dict:
    """decode_file through TorchDSP on the card: exact byte-equal to the
    native decoder, fast within the fast contract; K4 launched in both."""
    from pdmp3_tpu.api import decode_file
    from pdmp3_tpu.host import native_decode_file
    from pdmp3_tpu.testing import mp3gen
    from pdmp3_tpu_torch import TorchDSP

    streams = {name: mp3gen.make_stream(n_frames=8, seed=2, **spec)
               for name, spec in API_CONFIGS.items()}
    res = {"streams": len(streams)}
    reset_launch_counts()
    for exact in (True, False):
        mode = "exact" if exact else "fast"
        n0 = launch_counts("phase 8", "back_half")
        t0 = time.perf_counter()
        worst = []
        for name, data in streams.items():
            got = decode_file(data, dsp=TorchDSP(exact=exact, device=dev))
            want = native_decode_file(data)
            check(len(want) > 0 and len(got) == len(want),
                  f"phase 8: {name} {mode}: {len(got)} vs {len(want)} B")
            if exact:
                check(got == want, f"phase 8: {name} exact differs from "
                                   "the native decoder")
            lsb, frac = pcm_error(
                torch.from_numpy(np.frombuffer(got, "<i2").copy()),
                torch.from_numpy(np.frombuffer(want, "<i2").copy()))
            check(lsb <= MAX_LSB and frac < MAX_FRAC,
                  f"phase 8: {name} {mode} {lsb} LSB on {frac:.4%}")
            worst.append((lsb, frac))
        res[f"{mode}_seconds"] = time.perf_counter() - t0
        res[f"{mode}_k4_launches"] = launch_counts("phase 8",
                                                   "back_half") - n0
        res[f"{mode}_max_lsb"] = max(w[0] for w in worst)
        res[f"{mode}_max_frac_differing"] = max(w[1] for w in worst)
        check(res[f"{mode}_k4_launches"] > 0,
              f"phase 8: {mode} decode launched no K4")
    res["k4_launches"] = launch_counts("phase 8", "back_half")
    return res


def phase_sweep(dev) -> dict:
    """K6: the three rounding points over all 2^32 inputs, then one
    chunk's kernel and plain times."""
    from pdmp3_tpu_torch.ops import rounding as R

    reset_launch_counts()
    res = {"results": [R.sweep(name, device=dev) for name in R.CONSTRUCTIONS]}
    res["launches"] = launch_counts("phase 9", "rounding_sweep")
    check(res["launches"] == 256 * len(R.CONSTRUCTIONS),
          f"phase 9: {res['launches']} sweep launches")
    for r in res["results"]:
        check(r["mismatching_chunks"] == [] and r["chunks_swept"] == 256,
              f"phase 9: {json.dumps(r)}")
    n = 1 << 24
    x = R.chunk_inputs(n, n, dev)
    res["chunk_inputs"] = n
    res["kernel_ms"] = {name: median_ms(
        lambda: R.rounding_sweep_step(name, n, n, dev), SWEEP_TIMED)
        for name in R.CONSTRUCTIONS}
    res["plain_ms"] = {name: median_ms(lambda: R.PLAIN[name](x),
                                       SWEEP_TIMED)
                       for name in R.CONSTRUCTIONS}
    res["seconds"] = sum(r["seconds"] for r in res["results"])
    res["max_abs_err"] = max(r["max_abs_err"] for r in res["results"])
    return res


def phase_main_path(streams: list[bytes], dev, watch: list[int],
                    exact: bool = False) -> dict:
    """StreamDecoder serving at B slots, fast (K1) or exact (K2); returns
    timings, with an exact_ prefix when exact, and the PCM of the watched
    slots."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder

    path = f"main path (exact={exact})"
    kernel = "fused_granule_exact" if exact else "fused_granule"
    dec = StreamDecoder(B, exact=exact, device=dev)
    feeder = LoopFeeder(dec, streams)
    sel = torch.tensor(watch, device=dev)
    kept, events, feed_s, parse_s = [], [], [], []
    decoded = 0
    reset_launch_counts()
    for step in range(WARMUP_STEPS + TIMED_STEPS):
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
        pcm = dec.decode_step(fetch=False)
        b.record()
        events.append((a, b))
        kept.append(pcm.index_select(0, sel))
        decoded += 1
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    launches = launch_counts(path, kernel)
    check(launches == 2 * decoded,
          f"{path}: {launches} {kernel} launches for {decoded} frame steps")

    # the device half alone, replayed on the last uploaded wire
    from pdmp3_tpu_torch.models.decoder import decode_frame_packed
    wire = dec._wires_t[dec._cur ^ 1].to(dev)
    state = clone_state(dec.state)
    replay_ms = median_ms(
        lambda: decode_frame_packed(wire, state, B=B, exact=exact),
        TIMED_STEPS)

    step_ms = float(np.median([a.elapsed_time(b)
                               for a, b in events[WARMUP_STEPS:]]))
    audio_s = B * 1152 / 44100.0
    pcm = torch.cat(kept, 1).cpu().numpy()        # [watched, steps*1152, 2]
    check(pcm.shape == (len(watch), decoded * 1152, 2)
          and pcm.dtype == np.int16, f"main path: PCM {pcm.shape}")
    check(bool(pcm.any(axis=(1, 2)).all()), "main path: a slot is silent")
    pre = "exact_" if exact else ""
    return {f"{pre}{k}" if k not in ("batch_slots", "steps", "_pcm")
            else k: v for k, v in {
        "batch_slots": B,
        "steps": TIMED_STEPS,
        "step_ms": step_ms,
        "device_replay_step_ms": replay_ms,
        "loop_ms_per_step": loop_ms,
        "host_feed_ms_per_step": float(np.median(feed_s[WARMUP_STEPS:]))
        * 1e3,
        "host_parse_ms_per_step": float(np.median(parse_s[WARMUP_STEPS:]))
        * 1e3,
        "aggregate_realtime_factor_per_chip": audio_s / (step_ms / 1e3),
        "aggregate_realtime_factor_per_chip_e2e": audio_s / (loop_ms / 1e3),
        "granules_per_sec": 2 * B / (step_ms / 1e3),
        "granules_per_sec_e2e": 2 * B / (loop_ms / 1e3),
        "kernel_launches": launches,
        "frame_steps": decoded,
        "_pcm": pcm,
    }.items()}


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


def phase_correctness(pcm: np.ndarray, watch: list[int],
                      specs: list[tuple[bytes, dict]],
                      exact: bool = False) -> list[dict]:
    """Each watched slot's PCM against the native scalar decoder over
    the aligned prefix (the slot keeps decoding its looping stream):
    bitwise when exact, else the fast contract."""
    from pdmp3_tpu.host import native_decode_file

    out = []
    for row, slot in enumerate(watch):
        data, spec = specs[slot % len(specs)]
        want = np.frombuffer(native_decode_file(data), "<i2")
        got = pcm[row]
        got = got[:, 0] if spec["mode"] == 3 else got.reshape(-1)
        check(len(want) > 0 and len(got) >= len(want),
              f"slot {slot}: {len(got)} samples for {len(want)} native")
        d = np.abs(got[:len(want)].astype(np.int32) - want.astype(np.int32))
        lsb, frac = int(d.max()), float((d != 0).mean())
        out.append({"slot": slot, "blocks": spec["blocks"],
                    "mode": spec["mode"],
                    "mode_extension": spec.get("mode_extension", 0),
                    "sfreq": spec["sfreq"], "samples": int(len(want)),
                    "max_lsb": lsb, "frac_differing": frac})
        check(lsb == 0 if exact else lsb <= MAX_LSB and frac < MAX_FRAC,
              f"slot {slot} (exact={exact}): {lsb} LSB on {frac:.4%} vs "
              "native")
    return out


def watched_slots(specs: list[tuple[bytes, dict]]) -> list[int]:
    """One slot per (blocks, mode, sfreq) feature the phase must cover."""
    want = [("blocks", "long"), ("blocks", "short"), ("blocks", "mixed"),
            ("blocks", "varied"), ("mode_extension", 2),
            ("mode_extension", 3), ("mode", 3), ("sfreq", 1),
            ("sfreq", 2)]
    slots = []
    for key, val in want:
        slots.append(next(i for i, (_, s) in enumerate(specs)
                          if s.get(key) == val and i not in slots))
    return slots


def ptxas_summary(log: str) -> list[str]:
    """Registers, shared memory and spills of each kernel from nvcc's
    -Xptxas -v report."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"I(L\w+?)E", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif "spill stores" in ln:
            out.append(f"{name}: {ln.split(',', 1)[1].strip()}")
        elif "registers" in ln:
            out[-1] += "; " + ln.split(":", 1)[1].strip()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 10: torch.profiler over serving steps "
                         "and a parse-thread sweep")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from pdmp3_tpu_torch import device

    dev = device.require_cuda()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    from pdmp3_tpu_torch.ops import _build
    _build.ensure_built()
    with open(_build.LOG) as f:
        ptxas = ptxas_summary(f.read())
    print(f"kernel build {time.perf_counter() - t0:.1f} s; "
          + " | ".join(ptxas))

    t0 = time.perf_counter()
    specs = corpus()
    streams = [s for s, _ in specs]
    print(f"corpus: {len(streams)} streams x {FRAMES_PER_STREAM} frames "
          f"in {time.perf_counter() - t0:.1f} s")
    fr = parsed_frame(streams, dev)

    k1 = phase_kernel(fr, exact=False)
    print("phase 2 K1 vs plain:", json.dumps(k1))

    watch = watched_slots(specs)
    m = phase_main_path(streams, dev, watch)
    print("phase 3 main path:",
          json.dumps({k: v for k, v in m.items() if k != "_pcm"}))
    slots = phase_correctness(m["_pcm"], watch, specs)
    print("phase 4 vs native:", json.dumps(slots))

    k2 = phase_kernel(fr, exact=True)
    print("phase 5 K2 vs plain:", json.dumps(k2))

    me = phase_main_path(streams, dev, watch, exact=True)
    slots = phase_correctness(me.pop("_pcm"), watch, specs, exact=True)
    me["exact_over_fast_step_ms"] = me["exact_step_ms"] / m["step_ms"]
    print("phase 6 exact main path:", json.dumps(me))
    print("phase 6 vs native (bitwise):", json.dumps(slots))

    k4 = phase_back_half(fr)
    print("phase 7 K4 vs plain, fused vs split:", json.dumps(k4))
    del fr

    api = phase_api(dev)
    print("phase 8 TorchDSP decode_file:", json.dumps(api))

    k6 = phase_sweep(dev)
    print("phase 9 K6 sweep:", json.dumps(k6))
    if args.profile:
        print("phase 10 profile:", json.dumps(phase_profile(streams, dev)))
    check("jax" not in sys.modules, "JAX was imported")

    def entry(name, src, launches, err, ms, plain_ms, **extra):
        return {"name": name, "route": "cuda", "source": CSRC + src,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **extra}
    print(json.dumps({"kernels": [
        entry("fused_granule", "fused_granule.cu", m["kernel_launches"],
              k1["pcm_max_lsb"], k1["kernel_ms"], k1["plain_ms"]),
        entry("fused_granule_exact", "fused_granule.cu",
              me["exact_kernel_launches"], k2["pcm_max_lsb"],
              k2["kernel_ms"], k2["plain_ms"]),
        entry("back_half", "back_half.cu", api["k4_launches"],
              max(k4["exact"]["max_abs_err"], k4["fast"]["max_abs_err"]),
              k4["exact"]["kernel_ms"], k4["exact"]["plain_ms"],
              ms_fast=k4["fast"]["kernel_ms"],
              plain_ms_fast=k4["fast"]["plain_ms"]),
        entry("rounding_sweep", "rounding_sweep.cu", k6["launches"],
              k6["max_abs_err"], sum(k6["kernel_ms"].values()),
              sum(k6["plain_ms"].values()),
              sweep_seconds=k6["seconds"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
