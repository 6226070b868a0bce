"""A ``torch.profiler`` trace of the device-only fast step loop: K1 twice
per frame step on wires already on the device, no host feed.

    python -m pdmp3_tpu_torch.tools.kernel_trace --batch 8192 --steps 32
    python -m pdmp3_tpu_torch.tools.kernel_trace --batch 16 --steps 2 \\
        --device cpu

Counterpart of ``tools/kernel_trace.py``.  Four steps of natively parsed
wire (``StreamDecoder`` fed by ``LoopFeeder`` from 8 looping streams)
are uploaded once; ``--steps`` frame steps then decode them in turn
(``models.decoder.decode_frame_packed``: the coded lines widened by
K10, the other sections widened, two K1 launches) on one recurrent state, untraced, then once more
under ``utils.trace.Trace`` (a Chrome trace file showing the kernels and
the gaps between them).  The summary's step times are CUDA events
around each loop over its steps (the host clock on the CPU); the traced
loop's says what the profiler costs.  No time is read from the trace,
which is for viewing only: on an H100 a profiler session has lost
launches once the process had run other work.  Writes the
trace and ``summary.json`` into ``--out``
(``build/torch_tools/kernel_trace/`` by default).
"""
from __future__ import annotations

import argparse
import json
import os

from . import (card, check_launches, cuda_ms, default_out, launched_since,
               launches, resolve_device, write_json)
from .drain_trace import corpus

RESIDENT = 4


def resident_wires(B: int, dev) -> list:
    """RESIDENT consecutive steps of parsed wire (the MPEG-1 pool's coded
    wire, the length its upload takes), each on `dev`."""
    from ..runtime import LoopFeeder, StreamDecoder

    dec = StreamDecoder(B, exact=False, device=dev)
    feeder = LoopFeeder(dec, corpus())
    wires = []
    for _ in range(RESIDENT):
        feeder.step()
        dec.parse_step()
        wires.append(dec._wires_t[dec._cur][:dec._upload_len()].to(
            dev, copy=True))
    return wires


def run(B: int, steps: int, out_dir: str, dev) -> dict:
    from ..models import decoder as M
    from ..utils.trace import Trace

    wires = resident_wires(B, dev)
    state = M.init_state(B, dev)

    def loop():
        for k in range(steps):
            M.decode_frame_packed(wires[k % RESIDENT], state, B=B)

    M.decode_frame_packed(wires[0], state, B=B)    # warm: kernels load
    before = launches()
    _, ms = cuda_ms(dev, loop)
    check_launches(dev, launched_since(before), "fused_granule", 2 * steps,
                   "device-only step loop", widened=steps)
    with Trace(out_dir):
        _, traced_ms = cuda_ms(dev, loop)
    return {"batch": B, "steps": steps, "device": str(dev),
            "card": card(dev),
            "clock": "cuda events" if dev.type == "cuda" else "host",
            "step_ms": ms / steps,
            "audio_s_per_s": B * 1152 / 44100.0 / (ms / steps / 1e3),
            "traced_step_ms": traced_ms / steps,
            "trace_dir": out_dir,
            "trace_files": sorted(f for f in os.listdir(out_dir)
                                  if f.endswith(".json"))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("kernel_trace"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    res = run(args.batch, args.steps, args.out, resolve_device(args.device))
    write_json(os.path.join(args.out, "summary.json"), res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
