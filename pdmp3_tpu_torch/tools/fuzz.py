"""Coverage-guided fuzz campaign over the port's native frontend.  Runs
on the host; it needs no card.

    python -m pdmp3_tpu_torch.tools.fuzz --iters 200000
    python -m pdmp3_tpu_torch.tools.fuzz --iters 50000 --rng-seed 7

Counterpart of ``tools/fuzz.py``.  Builds the port's mini-AFL driver
(``host.build.fuzzer_bin``: GCC trace-pc edge coverage + ASan/UBSan over
the library's translation units), seeds it (``make_seeds``) with mp3gen
streams spanning the format matrix (MPEG-1, LSF, free format, Layer
I/II, an ID3-tagged stream) with truncated and corrupted variants, plus
libshine / libmp3lame streams and a muxer-tagged one where libavcodec
is present, runs ``--iters`` mutations and merges its stats into the
cumulative ``--out`` (``build/torch_tools/fuzz.json`` by default).  A
sanitizer abort exits 1 and keeps the offending input, with its RNG
seed in its name, in ``fuzz_crashes/`` beside ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import default_out, write_json


def _real_encoder_seeds() -> list[bytes]:
    """libmp3lame / libshine streams and a muxer-tagged stream: structure
    mp3gen never emits (psychoacoustic block switching, LAME VBR
    reservoir, ancillary bytes, a Xing/LAME frame); none without
    libavcodec / libavformat."""
    from ..testing.avref import (av_encmux, av_encode, ensure_av_encmux,
                                 ensure_av_encode)
    from ..testing.signals import make_pcm

    out = []
    try:
        if ensure_av_encode() is not None:
            pcm = make_pcm("transient", 44100, 2, seconds=0.35, seed=913)
            out.append(av_encode(pcm, "libmp3lame", 44100, 2, 128000,
                                 "vbr:4"))
            out.append(av_encode(
                make_pcm("tonal", 32000, 1, seconds=0.3, seed=914),
                "libshine", 32000, 1, 64000))
        if ensure_av_encmux() is not None:
            out.append(av_encmux(
                make_pcm("sweep", 48000, 2, seconds=0.3, seed=915),
                48000, 2, 128000, "vbr:5"))
    except subprocess.CalledProcessError:
        pass               # an encoder the library lacks: mp3gen seeds only
    return out


def make_seeds(d: str) -> int:
    """Write the seed corpus into directory d; returns the file count."""
    from ..testing import mp3gen

    specs = [
        dict(n_frames=6, seed=900, blocks="varied", mode=1,
             mode_extension=2, use_reservoir=True),
        dict(n_frames=4, seed=901, blocks="short", mode=3, sfreq=1),
        dict(n_frames=4, seed=902, blocks="mixed", sfreq=2,
             mode=1, mode_extension=3, intensity_pos=True),
        dict(n_frames=4, seed=903, blocks="long", mode=2, stuffing=4),
        dict(n_frames=5, seed=904, blocks="varied", use_reservoir=True,
             scfsi=True),
        # MPEG-2/2.5 LSF seeds (parsed when the harness draws the
        # PDMP3_PROFILE_LSF round; otherwise exercise sync rejection)
        dict(n_frames=5, seed=905, family=1, blocks="varied", mode=1,
             mode_extension=1, stereo_extent_ch1=0.4, bitrate_index=11),
        dict(n_frames=4, seed=906, family=2, blocks="mixed", sfreq=2,
             mode=1, mode_extension=3, bitrate_index=11),
        dict(n_frames=4, seed=907, family=1, mode=3, use_reservoir=True,
             bitrate_index=11),
        # free-format seed (bitrate_index 0; parsed when the harness
        # draws PDMP3_PROFILE_FREE_FORMAT, else exercises rejection)
        dict(n_frames=5, seed=908, free_format_size=420, mode=0),
    ]
    extra_raw = [
        # Layer I/II seeds (parsed in PDMP3_PROFILE_L12 rounds or an L12
        # wire-pool round; otherwise the layer != 3 rejection)
        mp3gen.make_l12_stream(layer=1, n_frames=4, seed=910,
                               bitrate_index=12),
        mp3gen.make_l12_stream(layer=2, n_frames=4, seed=911,
                               bitrate_index=12, mode=3),
        mp3gen.make_l12_stream(layer=2, n_frames=3, seed=912,
                               bitrate_index=8),
    ]
    # ID3-tagged seed: small tag + stream (the mutator grows and splices
    # tags; PDMP3_PROFILE_ID3 rounds exercise the incremental skip and
    # the ring-wrap normalization)
    tag_size = 3000
    hdr = b"ID3" + bytes([4, 0, 0, (tag_size >> 21) & 0x7F,
                          (tag_size >> 14) & 0x7F,
                          (tag_size >> 7) & 0x7F, tag_size & 0x7F])
    extra_raw.append(hdr + bytes((i * 37) % 251 for i in range(tag_size))
                     + mp3gen.make_stream(n_frames=4, seed=909, mode=0))
    extra_raw += _real_encoder_seeds()
    n = 0
    for j, raw in enumerate(extra_raw):
        with open(os.path.join(d, f"r{j}.mp3"), "wb") as fh:
            fh.write(raw)
        n += 1
    for i, sp in enumerate(specs):
        data = mp3gen.make_stream(**sp)
        with open(os.path.join(d, f"s{i}.mp3"), "wb") as f:
            f.write(data)
        # hostile variants: truncation + mid-stream corruption
        with open(os.path.join(d, f"s{i}_trunc.mp3"), "wb") as f:
            f.write(data[:len(data) * 2 // 3 + 1])
        corrupt = bytearray(data)
        for k in range(50, len(corrupt), 97):
            corrupt[k] ^= 0xA5
        with open(os.path.join(d, f"s{i}_corrupt.mp3"), "wb") as f:
            f.write(bytes(corrupt))
        n += 3
    return n


def campaign(iters: int, rng_seed: int, crash_dir: str) -> dict:
    """One fuzzer run; its stats, or RuntimeError (with the reproducer
    saved in crash_dir) on a sanitizer abort."""
    from ..host.build import fuzzer_bin

    exe = fuzzer_bin()
    with tempfile.TemporaryDirectory() as td:
        seeds = make_seeds(td)
        cur = os.path.join(td, "cur_input.bin")
        t0 = time.perf_counter()
        p = subprocess.run(
            [exe, td, str(iters), cur, str(rng_seed)],
            capture_output=True, text=True,
            env={**os.environ,
                 "ASAN_OPTIONS": "abort_on_error=1:detect_leaks=1"})
        el = time.perf_counter() - t0
        if p.returncode != 0:
            os.makedirs(crash_dir, exist_ok=True)
            dst = os.path.join(crash_dir,
                               f"crash_seed{rng_seed}_{int(time.time())}.bin")
            if os.path.exists(cur):
                shutil.copy(cur, dst)
            raise RuntimeError(f"fuzzer exit {p.returncode}; reproducer "
                               f"{dst}\n{p.stderr[-4000:]}")
        stats = json.loads(p.stdout.strip().splitlines()[-1])
    return {**stats, "seeds": seeds, "rng_seed": rng_seed,
            "execs_per_sec": iters / max(el, 1e-9)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200_000)
    ap.add_argument("--rng-seed", type=int, default=1)
    ap.add_argument("--out", default=default_out("fuzz.json"))
    args = ap.parse_args(argv)
    crash_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                             "fuzz_crashes")
    try:
        stats = campaign(args.iters, args.rng_seed, crash_dir)
    except RuntimeError as e:
        print(f"CRASH: {e}", file=sys.stderr)
        sys.exit(1)
    merged = {"runs": [], "total_execs": 0, "crashes_found": 0}
    if os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
    merged["runs"].append(stats)
    merged["total_execs"] = sum(r["execs"] for r in merged["runs"])
    merged["edges_peak"] = max(r["edges"] for r in merged["runs"])
    write_json(args.out, merged)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
