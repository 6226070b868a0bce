"""Offline batched decode of a whole corpus with one upload.

Counterpart of ``pdmp3_tpu/models/offline.py`` (BASELINE.json
configs[3]: decode 1k files).  The native frontend parses every frame
of every file up front into time-major tensors [T, 2, B, ...], the
corpus moves to the device in one transfer per section, and a loop over
the frame axis (the JAX package's ``lax.scan``) threads the recurrent
state on the device: each frame is one ``decoder.decode_frame_soa``
step, K1 (fast) or K2 (exact) on CUDA, whose PCM stays on the device
until the end.  Streams shorter than T pad with inactive steps (state
frozen, silence).
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from . import decoder as M
from ..host import NativePDMP3, lib
from ..ops.dsp import M_NCH, META_WORDS


def parse_corpus(files: list[bytes]):
    """Parse every frame of every file with the native frontend
    (pdmp3_parse_stream, one call per file on a fresh handle).

    Returns time-major numpy step tensors: ix [T,2,B,2,576] int16, scf_l
    [T,2,B,2,22] uint8, scf_s [T,2,B,2,39] uint8, meta [T,2,B,32] int32,
    active [T,B] int32, nch [B]."""
    B = len(files)
    fn = lib().pdmp3_parse_stream
    fn.restype = C.c_long
    fn.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t, C.c_size_t,
                   C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p]
    per_file = []
    nch = np.ones(B, np.int32)
    for b, data in enumerate(files):
        # a fresh handle per file: open_feed keeps the persistent
        # scalefactor arrays (as the reference does, pdmp3.c:2369-2384),
        # so a reused handle would carry file b-1's scalefactors into
        # file b's silent granules and sfb21 over-reads
        h = NativePDMP3()
        # the smallest MPEG-1 Layer III frame is 96 bytes (bitrate index
        # 1 at 48 kHz, no padding): len/96 bounds the frame count
        # (zeroed: the parse leaves some words unwritten, e.g. mono ch1)
        tmax = len(data) // 96 + 4
        fi = np.zeros((2, tmax, 2, 576), np.int16)
        fl = np.zeros((2, tmax, 2, 22), np.uint8)
        fs = np.zeros((2, tmax, 2, 39), np.uint8)
        fm = np.zeros((2, tmax, META_WORDS), np.int32)
        t = fn(h._h, data, len(data), tmax,
               fi.ctypes.data_as(C.c_void_p), fl.ctypes.data_as(C.c_void_p),
               fs.ctypes.data_as(C.c_void_p), fm.ctypes.data_as(C.c_void_p))
        per_file.append((int(t), fi, fl, fs, fm))
        if t > 0:
            nch[b] = max(int(fm[0, 0, M_NCH]), 1)
    T = max((t for t, *_ in per_file), default=0)
    ix = np.zeros((T, 2, B, 2, 576), np.int16)
    scf_l = np.zeros((T, 2, B, 2, 22), np.uint8)
    scf_s = np.zeros((T, 2, B, 2, 39), np.uint8)
    meta = np.zeros((T, 2, B, META_WORDS), np.int32)
    active = np.zeros((T, B), np.int32)
    for b, (t, fi, fl, fs, fm) in enumerate(per_file):
        ix[:t, :, b] = fi[:, :t].transpose(1, 0, 2, 3)
        scf_l[:t, :, b] = fl[:, :t].transpose(1, 0, 2, 3)
        scf_s[:t, :, b] = fs[:, :t].transpose(1, 0, 2, 3)
        meta[:t, :, b] = fm[:, :t].transpose(1, 0, 2)
        active[:t, b] = 1
    return ix, scf_l, scf_s, meta, active, nch


def decode_files_scan(files: list[bytes], exact: bool = False,
                      bug_compat: bool = True, *, device) -> list[bytes]:
    """Decode a corpus of MPEG-1 files on ``device`` with one upload and
    one download.  exact=True reproduces the reference decoder's PCM bit
    for bit; exact=False is within 1 LSB.  Returns each file's PCM
    bytes (S16LE, mono files one channel)."""
    ix, scf_l, scf_s, meta, active, nch = parse_corpus(files)
    B = len(files)
    if ix.shape[0] == 0:
        return [b"" for _ in files]
    device = torch.device(device)

    def up(a, dtype=None):
        t = torch.from_numpy(a)
        # the granule steps take int16 scalefactors; meta stays int32, the
        # width its exponent-bitcast gains need ((n + 127) << 23)
        return (t if dtype is None else t.to(dtype)).to(device)
    d_ix, d_meta, d_act = up(ix), up(meta), up(active)
    d_scf_l, d_scf_s = up(scf_l, torch.int16), up(scf_s, torch.int16)
    state = M.init_state(B, device)
    pcms = []
    for t in range(ix.shape[0]):
        pcm, state = M.decode_frame_soa(d_ix[t], d_scf_l[t], d_scf_s[t],
                                        d_meta[t], d_act[t], state,
                                        bug_compat, exact)
        pcms.append(pcm)
    pcm = torch.stack(pcms).cpu().numpy()              # [T, B, 1152, 2]
    out = []
    for b in range(B):
        p = pcm[:int(active[:, b].sum()), b]
        out.append(p[:, :, 0].tobytes() if nch[b] == 1 else p.tobytes())
    return out
