"""Command-line decoder: the reference CLI's behaviour (pdmp3.c:2540-2589)
with selectable backends, on the PyTorch port.

    python -m pdmp3_tpu_torch.cli [options] file.mp3 [file2.mp3 ...]

Decodes each file to <file>.raw (S16LE interleaved), or to stdout with
"-", as the reference built with OUTPUT_RAW does.  A leading /dev/dsp*
argument is accepted and ignored, as the reference CLI takes it.  The
default backend is ``gpu`` (exact): it and the other gpu backends decode
on ``--device`` (default cuda) and fail when that device is not there.
The host decoders (``native``, ``oracle``) run only when asked for.
"""
from __future__ import annotations

import argparse
import sys


def _device(name: str):
    """The decode device: the CUDA card (RuntimeError when none is
    visible) or the CPU, where the kernels' plain versions run."""
    if name == "cpu":
        return "cpu"
    from .device import require_cuda
    return require_cuda()


def _decode(data: bytes, backend: str, lsf: bool = False,
            free_format: bool = False, id3: bool = False,
            layers12: bool = False, crc_check: bool = False,
            device: str = "cuda") -> bytes:
    if backend == "native":
        from .host import (PROFILE_CRC, PROFILE_FREE_FORMAT, PROFILE_ID3,
                           PROFILE_L12, PROFILE_LSF, native_decode_file)
        prof = (PROFILE_LSF if lsf else 0) \
            | (PROFILE_FREE_FORMAT if free_format else 0) \
            | (PROFILE_ID3 if id3 else 0) \
            | (PROFILE_L12 if layers12 else 0) \
            | (PROFILE_CRC if crc_check else 0)
        return native_decode_file(data, profile=prof)
    if backend == "oracle":
        from .api import decode_file
        return decode_file(data, lsf=lsf, free_format=free_format,
                           id3=id3, layers12=layers12, crc_check=crc_check)
    if backend in ("gpu", "gpu-exact", "gpu-fast"):
        from .api import decode_file
        from .models.decoder import TorchDSP
        dsp = TorchDSP(exact=backend != "gpu-fast", device=_device(device))
        return decode_file(data, dsp=dsp, lsf=lsf, free_format=free_format,
                           id3=id3, layers12=layers12, crc_check=crc_check)
    if backend == "batch":
        from .runtime import decode_files_batched
        if lsf or free_format or id3 or layers12:
            raise SystemExit("--lsf/--free-format/--id3/--layers12: use a "
                             "streaming backend (native/oracle/gpu)")
        return decode_files_batched([data], device=_device(device))[0]
    raise SystemExit(f"unknown backend {backend!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pdmp3", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="+",
                    help="MP3 files ('-' = stdin); a leading /dev/dsp* "
                         "argument is ignored (reference-CLI compat)")
    ap.add_argument("--backend", default="gpu",
                    choices=["native", "oracle", "gpu", "gpu-exact",
                             "gpu-fast", "batch"],
                    help="decode engine (default: gpu = gpu-exact, "
                         "bit-exact on --device; native = the C++ host "
                         "decoder, oracle = the NumPy reference)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the gpu and batch backends decode "
                         "(default cuda; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (single input only; default "
                         "<file>.raw, '-' = stdout)")
    ap.add_argument("--lsf", action="store_true",
                    help="also accept MPEG-2/2.5 (13818-3 LSF) streams "
                         "(beyond the reference)")
    ap.add_argument("--free-format", action="store_true",
                    help="accept free-format bitrate streams (frame "
                         "size deduced from the sync spacing)")
    ap.add_argument("--id3", action="store_true",
                    help="skip ID3v2 tags explicitly (tags larger than "
                         "the 16 KiB input ring would otherwise kill "
                         "the stream, as in the reference)")
    ap.add_argument("--layers12", action="store_true",
                    help="also decode MPEG Layer I/II frames (beyond "
                         "the reference, which rejects layer != 3)")
    ap.add_argument("--crc", action="store_true",
                    help="verify the ISO CRC-16 of protected frames and "
                         "skip failures (the reference discards CRC "
                         "bytes unchecked)")
    ap.add_argument("--info", action="store_true",
                    help="print stream metadata as JSON (Xing/Info/"
                         "VBRI/LAME tags, duration, gapless bounds) "
                         "and exit without decoding")
    ap.add_argument("--seek", type=float, default=None, metavar="SEC",
                    help="decode starting at SEC (bit-exact vs the "
                         "same window of a full decode)")
    ap.add_argument("--duration", type=float, default=None, metavar="SEC",
                    help="with --seek: decode only SEC seconds")
    ap.add_argument("--gapless", action="store_true",
                    help="apply LAME encoder delay/padding trim "
                         "(exact original sample count)")
    ap.add_argument("--wav", action="store_true",
                    help="write a RIFF/WAVE container instead of raw "
                         "S16LE (output defaults to <file>.wav)")
    args = ap.parse_args(argv)

    files = list(args.files)
    if files and files[0].startswith("/dev/dsp"):
        files = files[1:]
    if args.output and len(files) != 1:
        ap.error("-o requires exactly one input file")

    def dec(b: bytes) -> bytes:
        return _decode(b, args.backend, args.lsf, args.free_format,
                       args.id3, args.layers12, args.crc, args.device)

    for path in files:
        if path == "-":
            data = sys.stdin.buffer.read()
        else:
            with open(path, "rb") as f:
                data = f.read()
        if args.info:
            _print_info(path, data)
            continue
        if args.seek is not None or args.gapless:
            from . import metadata as M
            if args.seek is not None:
                pcm, sinfo = M.decode_file_seek(data, args.seek,
                                                args.duration, decode=dec)
            else:
                pcm, sinfo = M.decode_file_gapless(data, decode=dec)
            rate, nch = sinfo.sample_rate, sinfo.channels
        else:
            pcm = dec(data)
            rate = nch = None
        ext = ".wav" if args.wav else ".raw"
        out = args.output or (path + ext if path != "-" else "-")
        if args.wav:
            if rate is None:
                from . import metadata as M
                sinfo = M.parse_stream_info(data)
                if sinfo is None:
                    raise SystemExit(f"{path}: no MPEG frame sync found")
                rate, nch = sinfo.sample_rate, sinfo.channels
            from .utils.wav import wav_bytes
            pcm = wav_bytes(pcm, rate, nch)
        if out == "-":
            sys.stdout.buffer.write(pcm)
        else:
            with open(out, "wb") as f:
                f.write(pcm)
    return 0


def _print_info(path: str, data: bytes) -> None:
    import dataclasses
    import json

    from . import metadata as M
    info = M.parse_stream_info(data)
    if info is None:
        raise SystemExit(f"{path}: no MPEG frame sync found")
    d = dataclasses.asdict(info)
    d.pop("toc", None)                  # 100 raw bytes: not JSON-friendly
    d["duration_seconds"] = info.estimate_duration(len(data))
    d["total_samples"] = info.total_samples
    d["file"] = path
    print(json.dumps(d, indent=2))


if __name__ == "__main__":
    sys.exit(main())
