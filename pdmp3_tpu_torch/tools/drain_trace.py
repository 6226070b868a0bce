"""Sync against pipelined serving, with a ``torch.profiler`` trace of the
pipelined loop: host parse, H2D wire upload, device step and the
asynchronous D2H PCM drain overlapping in steady state.

    python -m pdmp3_tpu_torch.tools.drain_trace --batch 8192 --steps 12
    python -m pdmp3_tpu_torch.tools.drain_trace --batch 16 --steps 2 \\
        --device cpu

Counterpart of ``tools/drain_trace.py``.  ``StreamDecoder(B,
device=...)`` fast (K10 widens the coded wire, then K1), fed by ``LoopFeeder`` from 8 looping streams,
runs ``--steps`` steps twice: ``sync`` (``decode_step``, the PCM fetched
every step) and ``pipelined`` (``decode_step_pipelined``, the PCM
fetched one step late from a side-stream copy, ``drain_pending`` at the
end), both untraced, and then the pipelined mode once more under
``utils.trace.Trace`` for the trace (a Chrome trace file,
``*.pt.trace.json``).  The summary's times are the host clock
(``perf_counter``) around work that ends in a synchronisation; the
traced run's step time says what the profiler costs.  No time is read
from the trace, which is for viewing only: on an H100 a profiler
session has lost launches once the process had run other work.  Writes
the trace and ``summary.json`` into ``--out``
(``build/torch_tools/drain_trace/`` by default).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import (card, check_launches, default_out, launched_since, launches,
               resolve_device, write_json)


def corpus() -> list[bytes]:
    from ..testing import mp3gen

    return [mp3gen.make_stream(n_frames=30, seed=300 + i,
                               blocks=["long", "varied", "short",
                                       "mixed"][i % 4],
                               mode=1, mode_extension=2)
            for i in range(8)]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(mode: str, streams: list[bytes], B: int, steps: int, dev,
          trace_dir: str | None = None) -> dict:
    """`steps` steps of `mode` ("sync" or "pipelined") after a warm-up
    step; stage seconds and step ms on the host clock."""
    from ..runtime import LoopFeeder, StreamDecoder
    from ..utils.trace import Trace

    dec = StreamDecoder(B, exact=False, device=dev)
    feeder = LoopFeeder(dec, streams)
    feeder.step()
    dec.parse_step()
    dec.decode_step()                 # warm: the kernels load
    stage = {"parse": 0.0, "decode_dispatch": 0.0, "drain": 0.0}
    before = launches()
    _sync(dev)
    t0 = time.perf_counter()
    with Trace(trace_dir):
        for _ in range(steps):
            t = time.perf_counter()
            feeder.step()
            dec.parse_step()
            stage["parse"] += time.perf_counter() - t
            t = time.perf_counter()
            if mode == "sync":
                dec.decode_step()
                stage["drain"] += time.perf_counter() - t
            else:
                dec.decode_step_pipelined()
                stage["decode_dispatch"] += time.perf_counter() - t
        if mode != "sync":
            t = time.perf_counter()
            dec.drain_pending()
            stage["drain"] += time.perf_counter() - t
        _sync(dev)
        total = time.perf_counter() - t0    # before the trace is written
    check_launches(dev, launched_since(before), "fused_granule", 2 * steps,
                   f"{mode} serving", widened=steps)
    return {"mode": mode, "total_s": total, "steps": steps,
            "step_ms": total / steps * 1e3, "stage_s": stage,
            "audio_s_per_s": steps * 1152 * B / 44100.0 / total}


def run(B: int, steps: int, out_dir: str, dev) -> dict:
    """Both modes untraced, then the pipelined mode once more under the
    profiler, for its trace and for what tracing costs a step."""
    streams = corpus()
    sync = serve("sync", streams, B, steps, dev)
    pipelined = serve("pipelined", streams, B, steps, dev)
    traced = serve("pipelined", streams, B, steps, dev, trace_dir=out_dir)
    return {"batch": B, "device": str(dev), "card": card(dev),
            "clock": "host, each run ending in a synchronisation",
            "sync": sync, "pipelined": pipelined,
            "speedup": pipelined["audio_s_per_s"] / sync["audio_s_per_s"],
            "traced_pipelined_step_ms": traced["step_ms"],
            "trace_dir": out_dir,
            "trace_files": sorted(f for f in os.listdir(out_dir)
                                  if f.endswith(".json"))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("drain_trace"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    res = run(args.batch, args.steps, args.out, resolve_device(args.device))
    write_json(os.path.join(args.out, "summary.json"), res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
