"""Clear-text per-stage debug dumps.

Equivalent of the reference's DEBUG-gated dmp_* printfs (pdmp3.c:894-965):
human-readable dumps of the frame header, side info, scalefactors, Huffman
output and per-stage samples, for manual differential debugging against
another decoder.  Enable on the Python decode path with
``PDMP3_DEBUG_DUMPS=1`` or call the functions directly.
"""
from __future__ import annotations

import sys

import numpy as np

from ..frontend import FrameData


def dump_header(fd: FrameData, out=sys.stdout) -> None:
    h = fd.header
    out.write(f"rate {h.bitrate_index},sfreq {h.sampling_frequency},"
              f"pad {h.padding_bit},mod {h.mode},modext {h.mode_extension},"
              f"emph {h.emphasis}\n")


def dump_side_info(fd: FrameData, out=sys.stdout) -> None:
    s = fd.side
    out.write(f"main_data_begin {s.main_data_begin}\n")
    for ch in range(fd.header.nch):
        out.write("scfsi " + " ".join(str(int(v)) for v in s.scfsi[ch])
                  + "\n")
        for gr in range(2):
            out.write(
                f"p23l {s.part2_3_length[gr][ch]},bv {s.big_values[gr][ch]},"
                f"gg {s.global_gain[gr][ch]},"
                f"scfc {s.scalefac_compress[gr][ch]},"
                f"wsf {s.win_switch_flag[gr][ch]},"
                f"bt {s.block_type[gr][ch]},mbf {s.mixed_block_flag[gr][ch]},"
                f"ts {list(map(int, s.table_select[gr][ch]))},"
                f"sbg {list(map(int, s.subblock_gain[gr][ch]))},"
                f"r0c {s.region0_count[gr][ch]},r1c {s.region1_count[gr][ch]},"
                f"pf {s.preflag[gr][ch]},scfs {s.scalefac_scale[gr][ch]},"
                f"c1ts {s.count1table_select[gr][ch]},"
                f"count1 {s.count1[gr][ch]}\n")


def dump_scalefactors(fd: FrameData, gr: int, ch: int,
                      out=sys.stdout) -> None:
    s = fd.side
    if s.win_switch_flag[gr][ch] and s.block_type[gr][ch] == 2:
        lo = 3 if s.mixed_block_flag[gr][ch] else 0
        if s.mixed_block_flag[gr][ch]:
            out.write("scfl " + ",".join(
                str(int(v)) for v in fd.scalefac_l[gr][ch][:8]) + "\n")
        for b in range(lo, 12):
            out.write(f"scfs{b} " + ",".join(
                str(int(v)) for v in fd.scalefac_s[gr][ch][b]) + "\n")
    else:
        out.write("scfl " + ",".join(
            str(int(v)) for v in fd.scalefac_l[gr][ch][:21]) + "\n")


def dump_huffman(fd: FrameData, gr: int, ch: int, out=sys.stdout) -> None:
    out.write("HUFFMAN\n")
    for i, v in enumerate(fd.ix[gr][ch]):
        out.write(f"{i}: {int(v)}\n")


def dump_samples(x: np.ndarray, stage: int, out=sys.stdout) -> None:
    """Per-stage sample dump in the reference's fixed-point format
    (rint(x*32768) clipped, pdmp3.c:953-964)."""
    out.write(f"SAMPLES{stage}\n")
    vals = np.clip(np.rint(np.asarray(x, np.float64) * 32768.0),
                   -32768, 32767).astype(int)
    for i, v in enumerate(vals):
        out.write(f"{i}: {v}\n")


def dump_frame(fd: FrameData, out=sys.stdout) -> None:
    """Everything the reference's DEBUG build prints per frame."""
    dump_header(fd, out)
    dump_side_info(fd, out)
    for gr in range(2):
        for ch in range(fd.header.nch):
            dump_scalefactors(fd, gr, ch, out)
            dump_huffman(fd, gr, ch, out)
