"""Dense against sparse wire, stage by stage, on the port's serving pools.

    python -m pdmp3_tpu_torch.tools.wire_profile --batch 8192
    python -m pdmp3_tpu_torch.tools.wire_profile --batch 16 --distinct 8 \\
        --steps 2 --e2e-seconds 0.2 --trials 1 --trial-seconds 0.2 \\
        --device cpu

Counterpart of ``tools/wire_profile.py``.  For ``StreamDecoder`` ("dense"
in the output, as the JAX tool names it; its MPEG-1 wire is the coded
one: 4-bit line codes and an escape list, widened on the device by K10)
and ``SparseStreamDecoder`` (the count1-bounded sparse wire)
at B slots, fast MPEG-1, fed by ``LoopFeeder`` from looping streams:

- a blocked step split into its stages: ``parse`` (the native parse into
  the pinned wire, host clock), ``upload`` (the pool's ``upload``: the
  wire's H2D copy), ``decode`` (the pool's ``advance``: the device step
  from the uploaded wire, the sparse re-densify or the coded wire's K10
  widening included, two K1 launches) and ``drain`` (the PCM's D2H copy), each device stage
  between CUDA events and synchronised (the host clock on the CPU), in
  ms per step; ``decode_step`` is those two parts, so the tool steps the
  pool as serving does;
- wire bytes per step and per granule;
- the sparse bucket trajectory (``SparseStreamDecoder._bucket_blocks``,
  sticky upward) over the warm-up and the timed steps;
- the pipelined loop (``decode_step_pipelined``), audio seconds per wall
  second, one synchronisation at its end;
- ``ab_compare``: the pipelined loop of both pools in alternating
  windows, each pool's median over the trials (one card's runs spread,
  so compare only within one run, interleaved).

What the JAX tool also had and this one has not: the ``zlib`` columns
measured how a TPU host's compressing network transport shrank each
wire, which no PCIe copy does; and its ``xla`` / ``pallas`` axis has no
counterpart, the port having one route per device.  Writes
``build/torch_tools/wire_profile.json`` unless ``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import (card, check_launches, cuda_ms, default_out, launched_since,
               launches, resolve_device, write_json)

WARMUP_STEPS = 6


def corpus(n_distinct: int = 128, n_frames: int = 40) -> list[bytes]:
    """`n_distinct` streams of the JAX tool's mix (blocks, modes, MS and
    intensity, bitrates, the three rates, reservoir)."""
    from ..testing import mp3gen

    streams = []
    i = 0
    while len(streams) < n_distinct:
        try:
            streams.append(mp3gen.make_stream(
                n_frames=n_frames, seed=300 + i,
                blocks=["long", "varied", "short", "mixed"][i % 4],
                mode=[0, 1, 1, 3][i % 4],
                mode_extension=(2 if i % 2 else 0) | (1 if i % 8 >= 6 else 0),
                bitrate_index=[9, 11, 14, 7][(i // 4) % 4],
                sfreq=i % 3,
                use_reservoir=i % 5 == 0))
        except AssertionError:
            pass
        i += 1
    return streams


def _pool(sparse: bool, B: int, streams: list[bytes], dev):
    from ..runtime import LoopFeeder, SparseStreamDecoder, StreamDecoder

    dec = (SparseStreamDecoder if sparse else StreamDecoder)(
        B, exact=False, device=dev)
    return dec, LoopFeeder(dec, streams)


def _parse(dec, feeder) -> int:
    feeder.step()
    return dec.parse_step()


def _blocked_step(dec, dev) -> dict:
    """One step of the pool's own ``decode_step`` parts (``upload``,
    ``advance``) and the PCM's copy to the host, each synchronised: their
    ms, and the bytes uploaded."""
    wire, up = cuda_ms(dev, dec.upload)
    pcm, de = cuda_ms(dev, lambda: dec.advance(wire))
    _, dr = cuda_ms(dev, lambda: pcm.cpu())
    return {"upload": up, "decode": de, "drain": dr,
            "bytes": wire.numel() * wire.element_size()}


def _pipelined(dec, feeder, seconds: float, dev) -> tuple[float, int]:
    """Audio seconds per wall second of the pipelined loop over
    `seconds` (at least one step), and the decode steps it ran; one
    synchronisation at the end."""
    granules, steps, decoded = 0, 0, 0
    t0 = time.perf_counter()
    while steps == 0 or time.perf_counter() - t0 < seconds:
        na = _parse(dec, feeder)
        if na:
            dec.decode_step_pipelined()
            granules += 2 * na
            decoded += 1
        steps += 1
    dec.drain_pending()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return granules * 576 / 44100.0 / (time.perf_counter() - t0), decoded


def profile(streams: list[bytes], B: int, sparse: bool, steps: int,
            e2e_seconds: float, dev) -> dict:
    """One wire's row: stages, bytes, buckets, the pipelined rate and
    the decode steps run (each launches K1 twice on CUDA)."""
    dec, feeder = _pool(sparse, B, streams, dev)
    buckets = []
    for _ in range(WARMUP_STEPS):
        _parse(dec, feeder)
        if sparse:
            buckets.append(dec._bucket_blocks())
    # first launch (loads the kernels)
    warm = int(dec.decode_step(fetch=False) is not None)
    wire_bytes = []
    t = {"parse": 0.0, "upload": 0.0, "decode": 0.0, "drain": 0.0}
    before = launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        _parse(dec, feeder)
        t["parse"] += (time.perf_counter() - t0) * 1e3
        if sparse:
            buckets.append(dec._bucket_blocks())
        stage = _blocked_step(dec, dev)
        wire_bytes.append(stage.pop("bytes"))
        for k, v in stage.items():
            t[k] += v
    check_launches(dev, launched_since(before), "fused_granule", 2 * steps,
                   f"{'sparse' if sparse else 'dense'} blocked steps",
                   widened=0 if sparse else steps)
    ms = {f"{k}_ms": v / steps for k, v in t.items()}
    wb = float(np.mean(wire_bytes))
    rate, decoded = _pipelined(dec, feeder, e2e_seconds, dev)
    return {
        "wire": "sparse" if sparse else "dense", "B": B, "steps": steps,
        **ms, "blocked_step_ms": sum(ms.values()),
        "wire_bytes_per_step": wb, "wire_bytes_per_granule": wb / (2 * B),
        "sparse_buckets": buckets if sparse else None,
        "pipelined_audio_s_per_s": rate,
        "decode_steps": warm + steps + decoded,
    }


def ab_compare(streams: list[bytes], B: int, trials: int, secs: float,
               dev) -> dict:
    """The pipelined loop of the dense and the sparse pool in alternating
    windows of `secs`; each wire's rates and median, and the decode
    steps run, in all and by wire."""
    pools = {w: _pool(w == "sparse", B, streams, dev)
             for w in ("dense", "sparse")}
    decoded = dict.fromkeys(pools, 0)
    for w, (dec, feeder) in pools.items():   # warm: kernels, sticky bucket
        for _ in range(4):
            _parse(dec, feeder)
        decoded[w] += dec.decode_step(fetch=False) is not None
    rates = {w: [] for w in pools}
    for _ in range(trials):
        for w, (dec, feeder) in pools.items():
            rate, n = _pipelined(dec, feeder, secs, dev)
            rates[w].append(rate)
            decoded[w] += n
    return {"trials": rates,
            "medians": {w: float(np.median(r)) for w, r in rates.items()},
            "decode_steps": sum(decoded.values()), "by_wire": decoded}


def run(streams: list[bytes], B: int, steps: int, e2e_seconds: float,
        trials: int, trial_seconds: float, dev) -> dict:
    """Both wires' rows and the A/B trials; ``decode_steps`` counts every
    decode step the run made, ``dense_decode_steps`` those of the dense
    pool (one K10 launch each on CUDA)."""
    rows = [profile(streams, B, sparse, steps, e2e_seconds, dev)
            for sparse in (False, True)]
    ab = ab_compare(streams, B, trials, trial_seconds, dev)
    return {"device": str(dev), "card": card(dev),
            "clock": "cuda events" if dev.type == "cuda" else "host",
            "distinct_streams": len(streams), "rows": rows,
            "sparse_over_dense_wire_bytes":
            rows[1]["wire_bytes_per_step"] / rows[0]["wire_bytes_per_step"],
            "ab": ab,
            "decode_steps": sum(r["decode_steps"] for r in rows)
            + ab["decode_steps"],
            "dense_decode_steps": rows[0]["decode_steps"]
            + ab["by_wire"]["dense"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--distinct", type=int, default=128)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--e2e-seconds", type=float, default=6.0)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--trial-seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("wire_profile.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = run(corpus(args.distinct, args.frames), args.batch, args.steps,
              args.e2e_seconds, args.trials, args.trial_seconds, dev)
    write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
