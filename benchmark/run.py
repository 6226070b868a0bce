"""Run one cell of the benchmark once, on one card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up loads the configuration's streams,
reads their frames with the stream reader it names and gives each slot
its source from the seed (``corpus``), and builds
the configuration's pool of ``pdmp3_tpu_torch`` (whose kernel and host
libraries build into ``build/`` inside the checkout on a first run);
the traffic mix's driver (``drivers/<name>.py``) then prepares and warms the cell's
own shapes and runs the window for the given seconds; after it, the
plain reference that the configuration names checks what the watched
slots delivered (``check``).  With ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the
cell's per-layer metrics, else its end-to-end ones.  The last line of
standard output is the result as one JSON object; the numbers compared
close standard error and the line.

Exits 2, printing no result, without a CUDA card, or with JAX or the
JAX package loaded once the window has closed; exits 1 where a traced
run's profiler saw other kernel launches than the port counted.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pdmp3_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


class _Window:
    """What happens at the window's start and close: the set-up clock
    stops, the memory peak and the launch counters start afresh, and in
    a traced run the profiler and its "window" annotation start."""

    def __init__(self, device, t0: float, traced: bool):
        self.device, self.t0, self.traced = device, t0, traced
        self.setup_s = None
        self.profile = self._annotation = None

    def start(self):
        import torch

        from pdmp3_tpu_torch import tools

        self.setup_s = time.perf_counter() - self.t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.before = tools.launches()
        if self.traced:
            from torch.profiler import record_function

            from .trace import Profile
            self.profile = Profile()
            self.profile.start()
            self._annotation = record_function("window")
            self._annotation.__enter__()

    def end(self):
        from pdmp3_tpu_torch import tools

        self.launched = tools.launched_since(self.before)
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)


def make_pool(pool_cfg: dict, device):
    """The pool a configuration's "pool" names: "class", a pool of
    ``pdmp3_tpu_torch``, with "slots" slots; every other key is an
    argument of that class (ValueError for one it does not take)."""
    import inspect

    import pdmp3_tpu_torch

    cls = getattr(pdmp3_tpu_torch, pool_cfg["class"])
    kw = {k: v for k, v in pool_cfg.items() if k not in ("class", "slots")}
    params = inspect.signature(cls).parameters
    unknown = sorted(set(kw) - set(params) | ({"device"} & set(kw)))
    if unknown:
        raise ValueError(f"{pool_cfg['class']} takes no {unknown}")
    return cls(pool_cfg["slots"], device=device, **kw)


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t0: float, overrides: dict | None = None,
             control: bool = False) -> dict:
    """One run of `cell` (``spec.Cell``) on `device`; the result line as
    a dict.  The traffic mix's "pool" and "kernel" merge into the
    configuration's; overrides merges into the configuration's "pool"
    and the traffic mix's entries (tests run tiny cells on the CPU so).  With
    control, the configuration's control takes the program's place:
    the program with its lower-precision path ("program": the control's
    "pool" settings), or the reference computed with TF32 operands
    ("reference_tf32"), judged by the same numbers and limits."""
    import numpy as np
    import torch

    from . import check, corpus, drive, spec
    from . import trace as tracing

    ov = overrides or {}
    tr = _merge(cell.traffic, {k: v for k, v in ov.items() if k != "pool"})
    cfg = _merge(cell.config, {"pool": tr.get("pool", {}),
                               "kernel": tr.get("kernel", {})})
    if control and cfg["control"]["kind"] == "program":
        cfg = _merge(cfg, {"pool": cfg["control"]["pool"]})
    cfg = _merge(cfg, {"pool": ov.get("pool", {})})
    fmt, pool_cfg, kern = cfg["format"], cfg["pool"], cfg["kernel"]
    reader, reference = spec.named(cfg, "reader"), spec.named(cfg, "reference")
    launch_bytes = spec.named(cfg, "kernel.bytes").launch_bytes
    cuda = device.type == "cuda"
    if cuda:
        from pdmp3_tpu_torch.host import lib
        from pdmp3_tpu_torch.ops import _build
        t = time.perf_counter()
        _build.ensure_built()
        lib()
        log(f"setup: kernel and host libraries ready in "
            f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    cor = corpus.build(cfg["streams"], tr, pool_cfg["slots"], seed, reader)
    log(f"setup: {len(cor.streams)} streams of {cor.period} frames in "
        f"{time.perf_counter() - t:.3f} s; {json.dumps(cor.encoder)}; "
        "content " + json.dumps(cor.stats()))
    pool = make_pool(pool_cfg, device)
    B = pool_cfg["slots"]
    spans = drive.Spans(traced)
    window = _Window(device, t0, traced)
    frame_s = fmt["samples_per_frame"] / fmt["sample_rate"]
    rec = spec.driver(tr["driver"])(pool, cor, tr, seconds, spans, window)
    summary = None
    if traced:
        torch.cuda.synchronize(device)
        summary = tracing.summarize(window.profile.stop(), kern["name"])
        counted = window.launched.get(kern["counter"], 0)
        log(f"trace: {summary['launches']} launches of {kern['name']} "
            f"seen, {counted} counted by the port ({window.launched}) in "
            f"{rec.steps} steps")
        tracing.verify(summary, counted, kern["name"])
        for label, sec in summary.pop("gaps"):
            log(f"trace: idle gap {sec:.6f} s while {label}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # every launch of a step covers its slots; its bytes follow from the
    # step's active slots
    kernel_bytes = summary and rec.steps and summary["launches"] * sum(
        launch_bytes(B, n, fmt) for n in rec.window_active) / rec.steps
    if summary is not None:
        log(f"trace: {kernel_bytes} bytes in the launches of {kern['name']}")
    pool = None   # the program's state goes before the reference
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    got, missing = drive.watched_frames(rec)
    ref = check.Reference(cor, reference, fmt)
    sound = None
    if control and cfg["control"]["kind"] == "reference_tf32":
        sound = check.judge(check.numbers(got, missing, ref),
                            cfg["limits"])[1]
        low = check.Reference(cor, reference, fmt, tf32=True)
        got = [low.frames(j, len(g)) for j, g in enumerate(got)]
    nums = check.numbers(got, missing, ref)
    ok, checks = check.judge(nums, cfg["limits"])
    log(f"check: {nums['frames_compared']} frames of {len(cor.watch)} "
        f"watched slots against the reference in "
        f"{time.perf_counter() - t:.3f} s")
    run = _RunView(steps=rec.steps,
                   window_s=rec.window_s, slot_frames=rec.slot_frames,
                   frame_s=frame_s,
                   setup_s=window.setup_s, spans=dict(spans.total),
                   trace=summary,
                   kernel_bytes=kernel_bytes)
    gaps = np.diff(rec.step_starts) if len(rec.step_starts) > 1 else [0.0]
    # steps in each tenth of the window: how steady the window ran
    tenths = np.histogram(rec.step_starts, 10, (rec.t_start, rec.t_start
                                                 + seconds))[0]
    log(f"window: {rec.steps} steps in {rec.window_s:.6f} s; step period "
        "ms at 10/50/90%: " + " ".join(
            f"{1e3 * np.percentile(gaps, q):.3f}" for q in (10, 50, 90))
        + "; steps by tenth of the window: " + " ".join(map(str, tenths))
        + "; spans " + json.dumps({k: round(v, 6)
                                   for k, v in run.spans.items()}))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    out = {"correct": ok, "attempted": rec.attempted,
           "failed": rec.attempted - sum(rec.window_active),
           "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if sound is not None:
        # the program's own numbers, where the control replaced them
        out["sound_checks"] = sound
    out["checks"] = checks
    return out


class _RunView:
    """What a metric's reader reads: the window's counts and clocks,
    the harness's spans, and in a traced run the device timeline."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from . import spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        log(f"no result: {cell.chips} CUDA card(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    from .trace import LostLaunches
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), _T0)
    except LostLaunches as e:
        log(f"no result: {e}")
        return 1
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"no result: modules loaded that the port must not use: "
            f"{', '.join(loaded)}")
        return 2
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
