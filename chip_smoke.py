#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Fast-mode MPEG-1 Layer III serving through ``pdmp3_tpu_torch`` at
B = 8192 stream slots, in four phases; any failure exits non-zero:

1. the card's name and power limit, then a check that CUDA is visible;
2. the hand-written granule kernel (built here from
   ``pdmp3_tpu_torch/csrc``) against its plain PyTorch version on the
   same CUDA tensors: one frame (two granule steps) of natively parsed
   wire, a few idle slots, a random starting state; both timed;
3. the main path: ``StreamDecoder(8192, device="cuda")`` fed by
   ``LoopFeeder`` from 64 distinct generated streams, 2 warm-up and 32
   timed frame steps of feed -> parse_step -> decode_step, with the
   kernel's launch count checked against the steps run;
4. the PCM of slots covering long, short, mixed, MS, intensity, mono,
   32 and 48 kHz streams against the native scalar C++ decoder.

    python3 chip_smoke.py --profile

adds a fifth phase after the fourth: ``torch.profiler`` over serving
steps (device time by kernel and copy, and the device's busy share of
the loop), then the serving loop at 1, 2, 4 and 8 parse threads.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import json
import os
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
KERNEL_SRC = "pdmp3_tpu_torch/csrc/fused_granule.cu"
REPLACES = "pdmp3_tpu/ops/pallas_step.py:771"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def phase_kernel(streams: list[bytes], dev) -> dict:
    """The kernel vs its plain version on one natively parsed frame."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.models.decoder import DecoderState, wire_sections
    from pdmp3_tpu_torch.ops import fused_step as FS

    dec = StreamDecoder(B, device=dev)
    LoopFeeder(dec, streams).step()
    check(dec.parse_step() == B, "phase 2: not every slot parsed a frame")
    w = wire_sections(torch.from_numpy(dec.wire.copy()).to(dev), B)
    del dec
    ix, scf_l, scf_s = w["ix"], w["scf_l"], w["scf_s"]
    meta = w["meta"].to(torch.int32)
    active = w["active"].to(torch.int32)
    active[list(INACTIVE)] = 0
    rng = np.random.default_rng(0)
    st0 = DecoderState(*(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
        for shape in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))

    def frame(step, state):
        outs = []
        for gr in range(2):
            pcm, state = step(ix[gr], scf_l[gr], scf_s[gr],
                              meta[gr].contiguous(), active, gr, state)
            outs.append(pcm)
        return torch.cat(outs, 1), state

    pk, sk = frame(FS.fused_granule_step, clone_state(st0))
    pr, sr = frame(FS.fused_granule_step_ref, clone_state(st0))
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
          f"phase 2: kernel vs plain PCM {lsb} LSB on {frac:.4%}")
    for name in ("pcm", "store", "v_blocks", "prev_lines"):
        check(res[f"{name}_bitwise_equal"],
              f"phase 2: {name} not bitwise equal to the plain version "
              f"({json.dumps(res)})")
    for s in INACTIVE:
        check(not bool(pk[s].any()), f"phase 2: idle slot {s} has PCM")
        for name in ("store", "v_blocks", "prev_lines"):
            check(torch.equal(getattr(sk, name)[s].view(torch.int32),
                              getattr(st0, name)[s].view(torch.int32)),
                  f"phase 2: idle slot {s} {name} changed")
    check(bool(pk[0].any()), "phase 2: active slot 0 is silent")

    # one granule step per timed call, each on its own state copy
    sk, sr = clone_state(st0), clone_state(st0)
    args = (ix[0], scf_l[0], scf_s[0], meta[0].contiguous(), active, 0)
    res["kernel_ms"] = median_ms(lambda: FS.fused_granule_step(*args, sk),
                                 TIMED_LAUNCHES)
    res["plain_ms"] = median_ms(
        lambda: FS.fused_granule_step_ref(*args, sr), TIMED_LAUNCHES)
    return res


def phase_main_path(streams: list[bytes], dev, watch: list[int]) -> dict:
    """StreamDecoder serving at B slots; returns timings and the PCM of
    the watched slots."""
    from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
    from pdmp3_tpu_torch.ops import fused_step as FS

    dec = StreamDecoder(B, device=dev)
    feeder = LoopFeeder(dec, streams)
    sel = torch.tensor(watch, device=dev)
    kept, events, feed_s, parse_s = [], [], [], []
    decoded = 0
    FS.LAUNCHES = 0
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
    launches = FS.LAUNCHES
    check(launches == 2 * decoded,
          f"main path: {launches} kernel launches for {decoded} frame steps")

    # the device half alone, replayed on the last uploaded wire
    from pdmp3_tpu_torch.models.decoder import decode_frame_packed
    wire = dec._wires_t[dec._cur ^ 1].to(dev)
    state = clone_state(dec.state)
    replay_ms = median_ms(
        lambda: decode_frame_packed(wire, state, B=B), TIMED_STEPS)

    step_ms = float(np.median([a.elapsed_time(b)
                               for a, b in events[WARMUP_STEPS:]]))
    audio_s = B * 1152 / 44100.0
    pcm = torch.cat(kept, 1).cpu().numpy()        # [watched, steps*1152, 2]
    check(pcm.shape == (len(watch), decoded * 1152, 2)
          and pcm.dtype == np.int16, f"main path: PCM {pcm.shape}")
    check(bool(pcm.any(axis=(1, 2)).all()), "main path: a slot is silent")
    return {
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
    }


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
            check(dec.parse_step() > 0, "phase 5: no active slot")
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
    check(bool(spans), "phase 5: the profiler saw no device activity")
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
                      specs: list[tuple[bytes, dict]]) -> list[dict]:
    """Each watched slot's PCM against the native scalar decoder over
    the aligned prefix (the slot keeps decoding its looping stream)."""
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
        check(lsb <= MAX_LSB and frac < MAX_FRAC,
              f"slot {slot}: {lsb} LSB on {frac:.4%} vs native")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 5: torch.profiler over serving steps "
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
    ptxas = []
    if os.path.exists(_build.LOG):
        with open(_build.LOG) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln
                     or "spill" in ln]
    print(f"kernel build {time.perf_counter() - t0:.1f} s; "
          + " | ".join(ptxas))

    t0 = time.perf_counter()
    specs = corpus()
    streams = [s for s, _ in specs]
    print(f"corpus: {len(streams)} streams x {FRAMES_PER_STREAM} frames "
          f"in {time.perf_counter() - t0:.1f} s")

    k = phase_kernel(streams, dev)
    print("phase 2 kernel vs plain:", json.dumps(k))

    watch = watched_slots(specs)
    m = phase_main_path(streams, dev, watch)
    pcm = m.pop("_pcm")
    print("phase 3 main path:", json.dumps(m))

    slots = phase_correctness(pcm, watch, specs)
    print("phase 4 vs native:", json.dumps(slots))
    if args.profile:
        print("phase 5 profile:", json.dumps(phase_profile(streams, dev)))
    check("jax" not in sys.modules, "JAX was imported")

    print(json.dumps({"kernels": [{
        "name": "fused_granule", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": m["kernel_launches"],
        "max_abs_err": k["pcm_max_lsb"], "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
