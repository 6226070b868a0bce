"""Tools that drive the port's serving system, each runnable as

    python -m pdmp3_tpu_torch.tools.<name> [--device cuda|cpu] [--out PATH]

``serving_diff`` (random streams through the sparse serving pool, fast
and exact, against the native decoder and the reference binary),
``scale_sim`` (the 100k-stream sharded step at its real size),
``wire_profile`` (dense against sparse wire, stage by stage),
``multihost_soak`` (randomized multi-process rounds over gloo), ``soak``
(the format-matrix differential soak), ``parse_scaling`` (the native
parse rate over thread counts against the card's K1 rate),
``drain_trace`` and ``kernel_trace`` (a ``torch.profiler`` trace with a
summary timed by CUDA events), ``resample_sweep`` (the resampler's
passband SNR and ripple) and ``fuzz`` (the coverage-guided frontend
fuzzer; host only).  ``kernel_ab.py`` runs by path
(``python3 pdmp3_tpu_torch/tools/kernel_ab.py``).

A tool runs on the card unless ``--device cpu`` is given
(``resolve_device``): without a card it raises and never moves to the
CPU by itself.  Its JSON result goes to ``--out``, by default under
``build/torch_tools/`` (``default_out``).  Nothing here acts at import.
"""
from __future__ import annotations

import json
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO, "build", "torch_tools")


def default_out(name: str) -> str:
    """build/torch_tools/`name`: a tool's default output path."""
    return os.path.join(OUT_DIR, name)


def resolve_device(name: str):
    """The torch.device a tool runs on: "cuda" is the current CUDA device
    (``device.require_cuda``, which raises without one), anything else is
    taken as named ("cpu", "cuda:1")."""
    import torch

    from .. import device

    if name == "cuda":
        return device.require_cuda()
    dev = torch.device(name)
    if dev.type == "cuda":
        device.require_cuda()
    return dev


def card(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu": the label every measured number is written beside."""
    if dev.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    lines = res.stdout.strip().splitlines()
    return lines[min(dev.index or 0, len(lines) - 1)]


def write_json(path: str, obj) -> None:
    """Write obj as indented JSON to path, making its directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


# below this many streams one process generates them (spawning costs more)
SPAWN_FROM = 64


def _generate(cfg: dict) -> bytes | None:
    """mp3gen's stream for cfg, or None for a generator-infeasible
    config."""
    from ..testing import mp3gen

    try:
        return mp3gen.make_stream(**cfg)
    except AssertionError:
        return None


def feasible_streams(cfgs, n: int, workers: int | None = None
                     ) -> list[bytes]:
    """mp3gen's streams of the first `n` feasible configs of the
    iterable `cfgs` (keyword dicts of ``make_stream``), in order, made by
    `workers` spawned processes (the same bytes for any count; by
    default one per core from SPAWN_FROM streams, else one).
    RuntimeError when `cfgs` runs out first.  Spawned workers import the
    caller's ``__main__`` again: a script that calls this with more than
    one worker needs an ``if __name__ == "__main__":`` guard."""
    import itertools

    if workers is None:
        workers = (os.cpu_count() or 1) if n >= SPAWN_FROM else 1
    cfgs = iter(cfgs)
    streams: list[bytes] = []
    pool = None
    if workers > 1:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        while len(streams) < n:
            batch = list(itertools.islice(cfgs, n - len(streams)))
            if not batch:
                break
            made = pool.map(_generate, batch) if pool else map(_generate,
                                                                batch)
            streams += [s for s in made if s is not None]
    finally:
        if pool:
            pool.shutdown()
    if len(streams) != n:
        raise RuntimeError(f"made {len(streams)} of {n} streams")
    return streams


def launches() -> dict:
    """Every kernel's launch count so far (``ops.launch.LAUNCHES``), by
    kernel, zeros included."""
    from ..ops.launch import KERNELS, LAUNCHES

    return {k: LAUNCHES[k] for k in KERNELS}


def launched_since(before: dict) -> dict:
    """The launches since the snapshot `before` (``launches()``), by
    kernel, only those with any."""
    return {k: n - before[k] for k, n in launches().items()
            if n != before[k]}


def check_launches(dev, got: dict, kernel: str, want: int, what: str,
                   widened: int = 0) -> None:
    """On CUDA, `got` (``launched_since``) must be exactly `want`
    launches of `kernel` and `widened` of K10 (``l3_expand``: an MPEG-1
    pool widens its coded wire once a step); on the CPU, where the plain
    versions run, no launch at all."""
    expect = ({k: n for k, n in ((kernel, want), ("l3_expand", widened))
               if n} if dev.type == "cuda" and want else {})
    if got != expect:
        raise RuntimeError(f"{what}: launched {got}, want {expect}")


def cuda_ms(dev, fn):
    """(fn's result, milliseconds): CUDA events around fn on `dev`'s
    current stream, synchronised; the host clock on the CPU."""
    import time

    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(dev)
    a.record(stream)
    out = fn()
    b.record(stream)
    b.synchronize()
    return out, a.elapsed_time(b)
