"""Differential soak: randomized format-matrix streams, each decoded by
the port's native C++ decoder, its Python oracle and, where it builds,
the reference binary; every ``--torch-every``-th stream also by
``api.decode_file(dsp=TorchDSP(exact=True, device=...))``, the split
route that runs K4 (instance 7) on the card.

    python -m pdmp3_tpu_torch.tools.soak --start 0 --count 2000
    python -m pdmp3_tpu_torch.tools.soak --count 8 --torch-every 4 \\
        --device cpu
    python -m pdmp3_tpu_torch.tools.soak --lsf --count 500
    python -m pdmp3_tpu_torch.tools.soak --real-encoder --count 200

Counterpart of ``tools/soak.py``, with its samplers and seed bases
(config RNG 200000 + i, stream seed 201000 + i; the LSF, real-encoder
and real-LSF modes offset both), so a failure here reproduces as a
``tests/test_fuzz_differential.py``-style seed.  The truth is the
reference binary where it builds (``testing.golden``); where it does
not, the native decoder, which replays the reference CLI bit for bit,
and the result records ``"reference": "not built: <reason>"``.  All
decoders must agree bitwise, except that a stream driving the reference
into its is[]-overflow regime holds only the prefix before the first
such frame (``golden.first_oob_frame``).

- ``--lsf``: MPEG-2/2.5 streams; the reference rejects them, so the
  oracle is the truth, native and (every Nth) ``TorchDSP`` must equal
  it.
- ``--real-encoder`` / ``--real-lsf``: libshine / libmp3lame streams of
  ``testing.signals`` program material (``testing.avref``); the LSF mode
  anchors against libmpg123 and libavcodec within 2e-3 of full scale
  (``testing.mpg123ref``).  A stream counts ``infeasible`` where
  libavcodec or libmpg123 is absent.

Results merge into ``--out`` (``build/torch_tools/soak.json`` by
default), so a soak can be split across runs; the exit code is 1 when
any stream failed.  A failing stream's bytes are written beside
``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import time

from . import (card, default_out, launched_since, launches, resolve_device,
               write_json)

CFG_BASE = 200000
STREAM_BASE = 201000
LSF_SEED_OFF = 500000
REAL_SEED_OFF = 800000
REAL_LSF_SEED_OFF = 900000

# program-material classes (testing/signals.py)
MATERIALS = ["transient", "transient", "tonal", "sweep",
             "noise", "speech", "silence", "clipped", "dc"]


def random_config(rng: random.Random) -> dict:
    """Format-matrix sampler (mirrors tests/test_fuzz_differential.py)."""
    mode = rng.choice([0, 1, 1, 2, 3])
    cfg = dict(
        n_frames=rng.randrange(4, 10),
        sfreq=rng.randrange(3),
        bitrate_index=rng.choice([5, 9, 11, 14]),
        mode=mode,
        blocks=rng.choice(["long", "short", "mixed", "varied"]),
        use_reservoir=rng.random() < 0.5,
        protection=rng.random() < 0.3,
        vary_padding=rng.random() < 0.5,
        stuffing=rng.choice([0, 0, 3, 8]),
        scfsi=rng.random() < 0.4,
        amp=rng.choice([3, 6, 20, 3000]),
        leading_garbage=rng.choice([0, 0, 0, 111]),
    )
    if mode == 1:
        ext = rng.randrange(1, 4)
        cfg["mode_extension"] = ext
        if ext & 1:
            cfg["intensity_pos"] = True
            cfg["stereo_extent_ch1"] = rng.uniform(0.2, 0.8)
    return cfg


def random_lsf_config(rng: random.Random) -> dict:
    """LSF format-matrix sampler (families 1/2; 13818-3 fields)."""
    mode = rng.choice([0, 1, 1, 3])
    cfg = dict(
        family=rng.choice([1, 2]),
        n_frames=rng.randrange(5, 12),
        sfreq=rng.randrange(3),
        bitrate_index=rng.choice([5, 9, 11, 14]),
        mode=mode,
        blocks=rng.choice(["long", "short", "mixed", "varied"]),
        use_reservoir=rng.random() < 0.5,
        protection=rng.random() < 0.3,
        vary_padding=rng.random() < 0.5,
        stuffing=rng.choice([0, 0, 3, 8]),
        amp=rng.choice([3, 6, 20, 3000]),
    )
    if mode == 1:
        cfg["mode_extension"] = rng.randrange(1, 4)
        if cfg["mode_extension"] & 1:
            cfg["stereo_extent_ch1"] = rng.uniform(0.2, 0.8)
    return cfg


def _one_real_segment(rng: random.Random) -> dict:
    """One encoded segment's config (codec, format, material, presets)."""
    codec = rng.choice(["libshine", "libmp3lame", "libmp3lame"])
    mode = "cbr"
    extras = {}
    if codec == "libmp3lame":
        mode = rng.choice(["cbr", "abr", f"vbr:{rng.randrange(10)}"])
        # LAME preset axes: algorithmic quality -q0..9, --lowpass,
        # joint-stereo off, reservoir off
        if rng.random() < 0.4:
            extras["q"] = rng.randrange(10)
        if rng.random() < 0.25:
            extras["cutoff"] = rng.choice([4000, 8000, 12000, 16000])
        if rng.random() < 0.2:
            extras["js"] = 0
        if rng.random() < 0.15:
            extras["reservoir"] = 0
    rate = rng.choice([32000, 44100, 48000])
    channels = rng.choice([1, 2, 2])
    return dict(
        codec=codec, mode=mode, rate=rate, channels=channels,
        bitrate=rng.choice([64000, 96000, 128000, 192000, 320000]),
        material=rng.choice(MATERIALS),
        seconds=rng.uniform(0.4, 0.9),
        extras=extras,
    )


def random_real_config(rng: random.Random) -> dict:
    """Real-encoder sampler: production codecs over randomized program
    material; ~15% of configs concatenate two or three segments with
    mid-stream rate/mode/channel changes (the NEW_FORMAT protocol,
    pdmp3.c:1252-1320, 2470-2472)."""
    segs = [_one_real_segment(rng)]
    if rng.random() < 0.15:
        segs.append(_one_real_segment(rng))
        if rng.random() < 0.3:
            segs.append(_one_real_segment(rng))
    return dict(segments=segs)


def random_real_lsf_config(rng: random.Random) -> dict:
    """Real-encoder LSF sampler: libmp3lame over every MPEG-2/2.5 rate,
    all LAME rate-control modes, randomized program material."""
    rate = rng.choice([24000, 22050, 16000, 12000, 11025, 8000])
    mode = rng.choice(["cbr", "abr", f"vbr:{rng.randrange(10)}"])
    hi = rate >= 16000
    bitrate = rng.choice([32000, 48000, 64000, 96000, 144000] if hi
                         else [16000, 24000, 32000, 48000, 64000])
    # the reference-parity 1152-byte read gate means a stream shorter
    # than ~2 gates emits nothing by design: keep low-bitrate streams
    # longer (16 kbps: >= 1.5 s ~ 3 KB)
    seconds = max(rng.uniform(0.4, 0.9), 24000.0 / bitrate)
    return dict(
        codec="libmp3lame", mode=mode, rate=rate,
        channels=rng.choice([1, 2, 2]),
        bitrate=bitrate,
        material=rng.choice(MATERIALS),
        seconds=seconds,
    )


@dataclasses.dataclass
class Soak:
    """What every stream of a run shares: the device TorchDSP runs on,
    its cadence, whether the reference binary built, and where a failing
    stream's bytes go."""
    dev: object
    torch_every: int
    reference: bool
    dump_dir: str

    def torch_due(self, i: int) -> bool:
        return bool(self.torch_every) and i % self.torch_every == 0

    def torch_decode(self, stream: bytes, lsf: bool = False) -> bytes:
        from ..api import decode_file
        from ..models.decoder import TorchDSP

        return decode_file(stream, lsf=lsf,
                           dsp=TorchDSP(exact=True, device=self.dev))

    def dump(self, stream: bytes, name: str) -> str:
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(self.dump_dir, name)
        with open(path, "wb") as f:
            f.write(stream)
        return path


def _forensics(ctx: Soak, stream: bytes, want: bytes, outs: dict,
               bad: list, seed: int) -> str:
    """On mismatch: diff stats, an in-process retry of the TorchDSP
    decode (flaky vs sticky), and a stream dump for post-mortem."""
    import numpy as np

    bits = [f"device={ctx.dev}"]
    b = np.frombuffer(want, np.int16)
    for k in bad:
        a = np.frombuffer(outs[k], np.int16)
        n = min(len(a), len(b))
        d = np.nonzero(a[:n] != b[:n])[0]
        mx = int(np.abs(a[d].astype(np.int64)
                        - b[d].astype(np.int64)).max()) if len(d) else 0
        bits.append(f"{k}:ndiff={len(d)},max={mx},lens={len(a)}/{len(b)}")
    if "torch" in bad:
        retry = ctx.torch_decode(stream)
        bits.append(f"retry_torch={'match' if retry == want else 'again'}")
    bits.append("dump=" + ctx.dump(stream, f"soak_fail_{seed}.mp3"))
    return ";".join(bits)


def soak_one(i: int, ctx: Soak) -> str:
    """Returns one of: ok / oob_prefix_ok / infeasible / FAIL:<detail>."""
    from ..api import decode_file
    from ..host import native_decode_file
    from ..testing import mp3gen
    from ..testing.golden import first_oob_frame, reference_decode

    rng = random.Random(CFG_BASE + i)
    cfg = random_config(rng)
    try:
        stream = mp3gen.make_stream(seed=STREAM_BASE + i, **cfg)
    except (AssertionError, RuntimeError):
        return "infeasible"
    outs = {"native": native_decode_file(stream),
            "oracle": decode_file(stream)}
    if ctx.torch_due(i):
        outs["torch"] = ctx.torch_decode(stream)
    if ctx.reference:
        want = reference_decode(stream)
    else:
        want = outs.pop("native")
    if all(o == want for o in outs.values()):
        return "ok"
    oob = first_oob_frame(stream)
    if oob is None:
        bad = [k for k, o in outs.items() if o != want]
        return (f"FAIL:strict-mismatch:{','.join(bad)}:"
                f"{_forensics(ctx, stream, want, outs, bad, i)}:{cfg}")
    n = min(oob, len(want))
    bad = [k for k, o in outs.items() if o[:n] != want[:n]]
    if bad:
        return (f"FAIL:prefix-mismatch@{oob}:{','.join(bad)}:"
                f"{_forensics(ctx, stream, want, outs, bad, i)}:{cfg}")
    return "oob_prefix_ok"


def soak_one_lsf(i: int, ctx: Soak) -> str:
    """LSF: no external oracle exists (the reference rejects id=0), so
    the Python oracle is the truth and native and (every Nth) TorchDSP
    must equal it.  Returns ok / infeasible / FAIL:<detail>."""
    from ..api import decode_file
    from ..host import PROFILE_LSF, native_decode_file
    from ..testing import mp3gen

    rng = random.Random(CFG_BASE + LSF_SEED_OFF + i)
    cfg = random_lsf_config(rng)
    try:
        stream = mp3gen.make_stream(seed=STREAM_BASE + LSF_SEED_OFF + i,
                                    **cfg)
    except (AssertionError, RuntimeError):
        return "infeasible"
    want = decode_file(stream, lsf=True)
    outs = {"native": native_decode_file(stream, profile=PROFILE_LSF)}
    if ctx.torch_due(i):
        outs["torch"] = ctx.torch_decode(stream, lsf=True)
    bad = [k for k, o in outs.items() if o != want]
    if not bad:
        return "ok"
    return (f"FAIL:lsf-mismatch:{','.join(bad)}:"
            f"{_forensics(ctx, stream, want, outs, bad, LSF_SEED_OFF + i)}:"
            f"{cfg}")


def soak_one_real(i: int, ctx: Soak) -> str:
    """Real-encoder streams (libshine / libmp3lame): the reference binary
    (or, where it does not build, native) against native, and every Nth
    stream the Python oracle and TorchDSP; strict bit-equality."""
    from ..api import decode_file
    from ..host import native_decode_file
    from ..testing.avref import av_encode, ensure_av_encode
    from ..testing.golden import reference_decode
    from ..testing.signals import make_pcm

    if ensure_av_encode() is None:
        return "infeasible"
    rng = random.Random(CFG_BASE + REAL_SEED_OFF + i)
    cfg = random_real_config(rng)
    stream = b""
    for k, seg in enumerate(cfg["segments"]):
        pcm = make_pcm(seg["material"], seg["rate"], seg["channels"],
                       seconds=seg["seconds"],
                       seed=STREAM_BASE + REAL_SEED_OFF + i + 7777 * k)
        try:
            stream += av_encode(pcm, seg["codec"], seg["rate"],
                                seg["channels"], seg["bitrate"],
                                seg["mode"], **seg["extras"])
        except subprocess.CalledProcessError:
            return "infeasible"            # encoder rejected the config
    if len(stream) < 400:
        return "infeasible"
    outs = {"native": native_decode_file(stream)}
    if ctx.torch_due(i):
        outs["oracle"] = decode_file(stream)
        outs["torch"] = ctx.torch_decode(stream)
    if not ctx.reference:
        want = outs.pop("native")
    else:
        try:
            # a timeout means the binary hung in its ring-wrap ghost-full
            # livelock (reached by real LAME VBR streams, seed 800819)
            want = reference_decode(stream, timeout=30.0)
        except subprocess.TimeoutExpired:
            if outs["native"] == decode_file(stream):
                return "ref_livelock"
            dump = ctx.dump(stream, f"soak_ref_hang_{REAL_SEED_OFF + i}.mp3")
            return f"FAIL:ref-hang-and-internal-mismatch:dump={dump}:{cfg}"
    bad = [k for k, o in outs.items() if o != want]
    if not bad:
        return "ok"
    # 320 kbps @ 32 kHz (1440-byte frames vs the 1152-byte read gate):
    # the reference's output is feed-cadence-dependent; a common prefix
    # with only the tail length differing is that divergence
    if ctx.reference and any(seg["rate"] == 32000
                             and seg["bitrate"] == 320000
                             for seg in cfg["segments"]):
        n = min(len(want), *(len(o) for o in outs.values()))
        if all(o[:n] == want[:n] for o in outs.values()):
            return "gate_1440_prefix_ok"
    return (f"FAIL:real-mismatch:{','.join(bad)}:"
            f"{_forensics(ctx, stream, want, outs, bad, REAL_SEED_OFF + i)}"
            f":{cfg}")


def soak_one_real_lsf(i: int, ctx: Soak) -> str:
    """Real-encoder LSF: LAME MPEG-2/2.5 streams through the LSF path
    (oracle and native bit-equal, every Nth TorchDSP too), anchored
    within 2e-3 of full scale against libmpg123 and, except at 24 kHz
    (a band-table split in the ecosystem), libavcodec."""
    import numpy as np

    from ..api import decode_file
    from ..host import PROFILE_LSF, native_decode_file
    from ..testing.avref import av_decode, av_encode, ensure_av_encode
    from ..testing.mpg123ref import have_mpg123, mpg123_decode
    from ..testing.signals import make_pcm

    if ensure_av_encode() is None or not have_mpg123():
        return "infeasible"
    rng = random.Random(CFG_BASE + REAL_LSF_SEED_OFF + i)
    cfg = random_real_lsf_config(rng)
    pcm = make_pcm(cfg["material"], cfg["rate"], cfg["channels"],
                   seconds=cfg["seconds"],
                   seed=STREAM_BASE + REAL_LSF_SEED_OFF + i)
    try:
        stream = av_encode(pcm, cfg["codec"], cfg["rate"], cfg["channels"],
                           cfg["bitrate"], cfg["mode"])
    except subprocess.CalledProcessError:
        return "infeasible"                # encoder rejected the config
    if len(stream) < 400:
        return "infeasible"
    py = decode_file(stream, lsf=True)
    nat = native_decode_file(stream, profile=PROFILE_LSF)
    if nat[:len(py)] != py:
        return f"FAIL:lsf-real-native-vs-python:{cfg}"
    if ctx.torch_due(i) and ctx.torch_decode(stream, lsf=True) != py:
        return f"FAIL:lsf-real-torch-vs-python:{cfg}"
    ours = np.frombuffer(py, "<i2").astype(np.float32) / 32768.0
    if ours.size == 0:
        # reference-parity read gate: a stream shorter than a few
        # 1152-byte gates legitimately emits nothing
        if len(stream) < 4 * 1152:
            return "gate_short"
        return f"FAIL:lsf-real-no-output:{cfg}"
    anchors = {"mpg123": mpg123_decode(stream)}
    if cfg["rate"] != 24000:
        anchors["libav"] = av_decode(stream)
    for name, ref in anchors.items():
        n = min(ours.size, ref.size)
        if n == 0 or ours.size - n > 8 * 576 * cfg["channels"]:
            return f"FAIL:lsf-real-length:{name}:{ours.size}/{ref.size}:{cfg}"
        d = float(np.abs(ours[:n] - ref[:n]).max())
        if d > 2e-3:
            dump = ctx.dump(stream,
                            f"soak_lsf_real_{REAL_LSF_SEED_OFF + i}.mp3")
            return f"FAIL:lsf-real-vs-{name}:maxdiff={d}:dump={dump}:{cfg}"
    return "ok"


MODES = {"mpeg1": soak_one, "lsf": soak_one_lsf, "real": soak_one_real,
         "real_lsf": soak_one_real_lsf}
TALLY = ("ok", "oob_prefix_ok", "infeasible", "ref_livelock", "gate_short",
         "gate_1440_prefix_ok")


def run(start: int, count: int, mode: str, torch_every: int, dev,
        dump_dir: str, progress_every: int = 0) -> dict:
    """Soak seeds [start, start + count) in `mode`; a tally, the failures
    and the launches TorchDSP made."""
    from ..testing.golden import reference_status

    reference = reference_status()
    ctx = Soak(dev, torch_every, reference == "built", dump_dir)
    fn = MODES[mode]
    tally = dict.fromkeys(TALLY, 0)
    failures = []
    before = launches()
    t0 = time.perf_counter()
    for k, i in enumerate(range(start, start + count)):
        r = fn(i, ctx)
        if r.startswith("FAIL"):
            failures.append({"seed": i, "detail": r})
            print(f"seed {i}: {r}", flush=True)
        else:
            tally[r] += 1
        if progress_every and (k + 1) % progress_every == 0:
            rate = (k + 1) / (time.perf_counter() - t0)
            print(f"[{k + 1}/{count}] {tally} fails={len(failures)} "
                  f"({rate:.1f} streams/s)", flush=True)
    torch_streams = sum(ctx.torch_due(i) for i in range(start, start + count))
    ran = launched_since(before)
    if dev.type == "cuda" and torch_streams and set(ran) != {"back_half"}:
        raise RuntimeError(f"TorchDSP launched {ran}, want K4 (back_half) "
                           "alone")
    return {"mode": mode, "range": [start, count], "tally": tally,
            "failures": failures, "torch_streams": torch_streams,
            "launches": ran, "reference": reference, "device": str(dev),
            "card": card(dev), "seconds": time.perf_counter() - t0}


def merge(path: str, res: dict) -> dict:
    """Add one run's result to the cumulative summary at `path`."""
    summary = {"ranges": [], "streams": 0, **dict.fromkeys(TALLY, 0),
               "failures": [], "seed_bases": {"config": CFG_BASE,
                                              "stream": STREAM_BASE},
               "runs": []}
    if os.path.exists(path):
        with open(path) as f:
            summary.update(json.load(f))
    summary["ranges"].append(res["range"])
    summary["streams"] += res["range"][1]
    for k, n in res["tally"].items():
        summary[k] = summary.get(k, 0) + n
    summary["failures"].extend(res["failures"])
    summary["runs"].append({k: v for k, v in res.items()
                            if k not in ("tally", "failures")})
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=2000)
    ap.add_argument("--torch-every", type=int, default=64,
                    help="every Nth stream also through TorchDSP(exact) "
                         "on --device (0 = never)")
    ap.add_argument("--progress-every", type=int, default=200)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--lsf", action="store_true",
                       help="MPEG-2/2.5 LSF streams")
    group.add_argument("--real-encoder", action="store_true",
                       help="libshine / libmp3lame streams")
    group.add_argument("--real-lsf", action="store_true",
                       help="libmp3lame MPEG-2/2.5 streams")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("soak.json"))
    args = ap.parse_args(argv)
    mode = ("lsf" if args.lsf else "real" if args.real_encoder
            else "real_lsf" if args.real_lsf else "mpeg1")
    res = run(args.start, args.count, mode, args.torch_every,
              resolve_device(args.device),
              os.path.dirname(os.path.abspath(args.out)),
              args.progress_every)
    summary = merge(args.out, res)
    write_json(args.out, summary)
    print(json.dumps({k: summary[k] for k in ("streams", "ok",
                                              "oob_prefix_ok", "infeasible")}
                     | {"failures": len(summary["failures"])}))
    if res["failures"]:
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
