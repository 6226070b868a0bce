"""Host parse throughput over thread counts, against the rate at which
the card consumes frames.

    python -m pdmp3_tpu_torch.tools.parse_scaling --slots 8192
    python -m pdmp3_tpu_torch.tools.parse_scaling --slots 64 --seconds 0.2 \\
        --threads 1 --trials 1 --device cpu

Counterpart of ``tools/parse_scaling.py``.  Runs the port's native parse
benchmark (``host.build.parsebench_bin``: feed, sync, side info,
reservoir, scalefactors, Huffman, line-ordered wire pack, over looping
streams) at ``--slots`` slots for ``--seconds`` per run, at 1, 2, 4, ...
threads up to ``os.cpu_count()``; then its ``-DPDMP3_PARSE_STATS`` build
at one thread for the per-stage cycle split (its rate is not a
throughput: the counters sit in the hot loops); then the Python serving
loop the port runs (``LoopFeeder.step`` -> ``parse_step``) at one
thread, its frames per second on the host clock.

The frames per second the card consumes is its own, measured in the
same run: K1's device time per launch at B = 8192 (``timing.graph_ms``,
CUDA events around CUDA-graph replays, on four parsed archetype
granules tiled across the slots) gives 8192 / (2 x K1 ms) MPEG-1 frames
per millisecond, and ``cores_to_saturate_card`` is that rate over the
best one-thread rate.  With ``--device cpu`` there is no card, and both
stay null.  Writes ``build/torch_tools/parse_scaling.json`` unless
``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

from . import card, default_out, resolve_device, write_json

K1_SLOTS = 8192


def thread_counts(limit: int) -> list[int]:
    """1, 2, 4, ... up to `limit`, and `limit` itself."""
    out, t = [], 1
    while t < limit:
        out.append(t)
        t *= 2
    return out + [limit]


def corpus_files(d: str) -> list[str]:
    """The JAX tool's 8 streams (60 frames, varied blocks, MS,
    reservoir), written into directory d."""
    from ..testing import mp3gen

    files = []
    for i in range(8):
        p = os.path.join(d, f"s{i}.mp3")
        with open(p, "wb") as f:
            f.write(mp3gen.make_stream(
                n_frames=60, seed=40 + i, blocks="varied", mode=1,
                mode_extension=2, use_reservoir=True))
        files.append(p)
    return files


def run_native(exe: str, n_slots: int, threads: int, seconds: float,
               files: list[str], trials: int) -> dict:
    rates = []
    for _ in range(trials):
        out = subprocess.run(
            [exe, str(n_slots), str(threads), str(seconds), *files],
            capture_output=True, text=True, check=True).stdout
        rates.append(json.loads(out)["frames_per_sec"])
    return {"n_threads": threads, "trials": trials,
            "frames_per_sec_median": statistics.median(rates),
            "frames_per_sec_max": max(rates),
            "frames_per_sec_all": rates}


def harness_rate(files: list[str], n_slots: int, seconds: float,
                 dev) -> float:
    """Frames per second of the port's serving parse at one thread:
    LoopFeeder.step + parse_step over `seconds`, host clock."""
    from ..runtime import LoopFeeder, StreamDecoder

    streams = []
    for p in files:
        with open(p, "rb") as f:
            streams.append(f.read())
    dec = StreamDecoder(n_slots, device=dev)
    feeder = LoopFeeder(dec, streams)
    feeder.step()
    dec.parse_step()
    frames = 0
    t0 = time.perf_counter()
    while frames == 0 or time.perf_counter() - t0 < seconds:
        feeder.step()
        frames += dec.parse_step()
    return frames / (time.perf_counter() - t0)


def k1_ms(dev) -> float:
    """K1's device time per launch at K1_SLOTS slots (timing.graph_ms)."""
    from .. import timing
    from ..models import decoder as M
    from ..ops.fused_step import fused_granule_step
    from .scale_sim import archetype_frames, tiled_batch

    b = tiled_batch(M.frame_to_batches(archetype_frames(), dev)[0],
                    K1_SLOTS)
    state = M.init_state(K1_SLOTS, dev)
    return timing.graph_ms(lambda: fused_granule_step(
        b.ix, b.scf_l, b.scf_s, b.meta, b.active, b.gr1, state))


def run(n_slots: int, seconds: float, threads: list[int], trials: int,
        dev, k1_device_ms: float | None = None) -> dict:
    """The sweep; k1_device_ms, when given, is K1's time measured
    elsewhere in the same run (else measured here on a card)."""
    from ..host.build import parsebench_bin

    exe = parsebench_bin()
    with tempfile.TemporaryDirectory() as td:
        files = corpus_files(td)
        rows = [run_native(exe, n_slots, t, seconds, files, trials)
                for t in threads]
        stats_out = subprocess.run(
            [parsebench_bin(stats=True), str(n_slots), "1", str(seconds),
             *files], capture_output=True, text=True, check=True).stdout
        harness = harness_rate(files, n_slots, seconds, dev)
    one = next((r for r in rows if r["n_threads"] == 1), None)
    per_core = one["frames_per_sec_max"] if one else None
    if k1_device_ms is None and dev.type == "cuda":
        k1_device_ms = k1_ms(dev)
    card_rate = (K1_SLOTS / (2 * k1_device_ms) * 1e3
                 if k1_device_ms else None)
    return {
        "host_cpus": os.cpu_count(), "device": str(dev), "card": card(dev),
        "slots": n_slots, "seconds_per_run": seconds,
        "native_rows": rows,
        "harness_frames_per_sec_1t": harness,
        "per_core_frames_per_sec": per_core,
        "k1_device_ms": k1_device_ms,
        "card_consume_frames_per_sec": card_rate,
        "cores_to_saturate_card": (card_rate / per_core
                                   if card_rate and per_core else None),
        "stage_cycles_note": ("-DPDMP3_PARSE_STATS build at one thread; "
                              "its rdtsc pairs inflate the run time, use "
                              "only the ratios between stages"),
        "stage_stats": json.loads(stats_out),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8192)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--threads", type=int, nargs="*",
                    help="thread counts (default 1, 2, 4, ... up to the "
                         "host's cores)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("parse_scaling.json"))
    args = ap.parse_args(argv)
    res = run(args.slots, args.seconds,
              args.threads or thread_counts(os.cpu_count() or 1),
              args.trials, resolve_device(args.device))
    write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
