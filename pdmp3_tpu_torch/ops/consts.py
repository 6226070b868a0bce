"""Constants of the Layer III granule step (fast and exact): per-(layout,
line) index maps and the small float tables, per family (0 MPEG-1,
1 MPEG-2, 2 MPEG-2.5).

The JAX package expands every per-line lookup as a one-hot matrix
product ([576, 9*K] constants), because its TPU gathers slowly.  A GPU
gathers at memory speed, so the port keeps the lookups as what they
are: int16 index maps ``line_maps()[map, layout, line]``, composed with
the short-block reorder exactly where the JAX package composes its
matrices (ops/dsp.py ``_compose_reorder``), and read by a plain index.
Both the plain PyTorch step and the CUDA kernel read these same arrays.

Only the index maps depend on the family: each family has its own band
edges and, for the LSF families, its mixed-block switch at long band 6
instead of 8 (``T.SWITCH_SFB_L``), all read from ``T.layout_maps(family)``
and ``T.stereo_maps(family)``.  Every array is derived from the port's
copy of the table module (``pdmp3_tpu_torch.tables``, byte-identical data
to the JAX package's), so there is one source of truth for the numbers.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (numeric guards)
from .. import tables as T

# rows of line_maps(): what each per-(layout, line) map holds
MAP_SFB_L = 0        # long scalefactor band, clipped to 0..21
MAP_SFB_S = 1        # flat short slot min(sfb,12)*3 + win, reorder-composed
MAP_SFB_S_PLAIN = 2  # the same slot in window-major (raw) line order
MAP_WIN = 3          # short window 0..2, reorder-composed (subblock gain)
MAP_PRETAB = 4       # pretab value of long lines, 0 elsewhere
MAP_SHORT = 5        # 1 on short-block lines
MAP_BAND_START = 6   # first line of the line's band (intensity bound)
MAP_IOK = 7          # 1 where the reference's intensity loops reach
MAP_SFB12 = 8        # 1 on short-block band-12 lines (exact band-12 gain)
N_MAPS = 9

# 2^(-d/4) and 2^(d/4) for d = 0..3, rounded to f32 (the fractional
# factor of the exponent-bitcast gains)
QUARTER_DOWN4 = np.array([2.0 ** 0, 2.0 ** -0.25, 2.0 ** -0.5,
                          2.0 ** -0.75], np.float32)
QUARTER_UP4 = np.array([2.0 ** 0, 2.0 ** 0.25, 2.0 ** 0.5,
                        2.0 ** 0.75], np.float32)
INV_SQRT2_F32 = np.float32(T.INV_SQRT2)
# the reference's C_INV_SQRT_2 in double: the exact MS butterfly rounds
# through float64 (pdmp3.c:1923-1925)
INV_SQRT2_F64 = float(T.INV_SQRT2)
POW43_MAX = 8206     # largest |ix| the table covers (pdmp3.c:2117)

# float offsets of the sections of granule_smem_image(), the table image
# K1 and K2 copy into shared memory once per block (csrc/
# granule_persist.cuh kT*): cos36 [18,36], imdct_win [4,36], c3p
# [3,18,36], win2p [3,36], nwin_t [32,64], synth_d [16,32]; every
# section and row starts 16-byte aligned
SMEM_COS36, SMEM_IWIN, SMEM_C3P, SMEM_W2P = 0, 648, 792, 2736
SMEM_NWIN_T, SMEM_SYND, SMEM_FLOATS = 2844, 4892, 5404

# float offsets of the sections of l12_smem_image(), K7's table image
# (csrc/l12_synth.cu kK7*): the NWIN rows that need a dot, transposed and
# packed [32, L12_COLS] (k, packed column); synth_d [16, 32]; the packed
# columns' store map, int32 bit patterns [L12_COLS]
L12_COLS = 36
L12_UT, L12_SYND, L12_MAP = 0, 32 * L12_COLS, 32 * L12_COLS + 512
L12_FLOATS = L12_MAP + L12_COLS
# a store-map entry: bits 0-7 the FIFO column the dot goes to, bits 8-15
# the column that mirrors it, bit 16 set when the mirror is the negation,
# bit 17 set when the mirror's dot over a row of +0.0 samples is -0.0
# (every coefficient of the mirror row has its sign bit set); a column
# number of L12_NONE or more stores nothing
L12_NONE = 64
L12_NEG = 1 << 16
L12_ZERO_NEG = 1 << 17


def compose_reorder(src: np.ndarray, family: int = 0) -> np.ndarray:
    """out[l, i] = src[l, perm_l[i]]: a per-(layout, line) map read in
    the wire's line order (the host applies the family's short-block
    reorder while it packs ix)."""
    return np.take_along_axis(np.asarray(src),
                              T.layout_maps(family)["reorder"], axis=1)


@functools.lru_cache(maxsize=None)
def pretab_line_map(family: int = 0) -> np.ndarray:
    """pretab value per (layout, line) for long regions (pdmp3.c:2123;
    13818-3 keeps the same pretab for LSF)."""
    m = T.layout_maps(family)
    pretab22 = np.concatenate([T.PRETAB, [0]]).astype(np.int32)
    out = np.zeros((T.N_LAYOUTS, 576), np.int32)
    for lay in range(T.N_LAYOUTS):
        sfb = m["sfb"][lay]
        long_mask = m["is_short"][lay] == 0
        out[lay][long_mask] = pretab22[np.minimum(sfb[long_mask], 21)]
    return out


@functools.lru_cache(maxsize=None)
def line_maps(family: int = 0) -> np.ndarray:
    """int16 [N_MAPS, 9, 576]: every per-(layout, line) index map of the
    family's step, rows named by the MAP_* constants."""
    lm, sm = T.layout_maps(family), T.stereo_maps(family)
    slot_s = np.minimum(lm["sfb"], 12) * 3 + lm["win"]
    maps = np.zeros((N_MAPS, T.N_LAYOUTS, 576), np.int16)
    maps[MAP_SFB_L] = np.clip(compose_reorder(lm["sfb"], family), 0, 21)
    maps[MAP_SFB_S] = compose_reorder(slot_s, family)
    # intensity reads short is_pos window-major even after the reorder
    # (the reference walks window-major spans of the reordered array,
    # pdmp3.c:2190-2220; LSF keeps the convention), hence the uncomposed
    # map
    maps[MAP_SFB_S_PLAIN] = slot_s
    maps[MAP_WIN] = compose_reorder(lm["win"], family)
    maps[MAP_PRETAB] = pretab_line_map(family)
    maps[MAP_SHORT] = lm["is_short"]
    maps[MAP_BAND_START] = sm["band_start"]
    maps[MAP_IOK] = sm["intensity_ok"]
    # reorder-invariant: the permutation moves lines only within a band
    maps[MAP_SFB12] = (lm["is_short"] == 1) & (lm["sfb"] == 12)
    maps.setflags(write=False)
    return maps


def granule_smem_image(c: dict) -> np.ndarray:
    """The shared-memory table image of K1 and K2 from the tables c
    (host_consts' entries), f32 [SMEM_FLOATS] laid out so that one
    16-byte load brings four coefficients one thread uses together:
    cos36 and imdct_win as they are (four consecutive outputs p); c3p[w,
    m, p] = c3[m, 6w + p - 6] and win2p[w, p] = win2[p - 6 - 6w], the
    short window w's basis and window re-indexed by the output p it
    lands on (zero where window w does not reach p: 6 + 6w <= p < 18 +
    6w); nwin_t = nwin transposed to [k, j] (four consecutive j); synth_d
    as it is."""
    c3p = np.zeros((3, 18, 36), np.float32)
    w2p = np.zeros((3, 36), np.float32)
    for w in range(3):
        p = np.arange(6 + 6 * w, 18 + 6 * w)
        c3p[w][:, p] = c["c3"][:, 6 * w + p - 6]
        w2p[w][p] = c["win2"][p - 6 - 6 * w]
    out = np.concatenate([c["cos36"].ravel(), c["imdct_win"].ravel(),
                          c3p.ravel(), w2p.ravel(), c["nwin"].T.ravel(),
                          c["synth_d"].ravel()]).astype(np.float32)
    assert out.size == SMEM_FLOATS
    return out


def nwin_row_map(nwin: np.ndarray) -> list[tuple[int, bool]]:
    """For each row j of the matrixing table nwin [64, 32]: (r, neg), the
    first row r <= j whose bits equal row j's (neg False) or their
    negation (neg True).  r == j marks a row that needs a dot of its own;
    any other row's dot is that of r, or its negation."""
    bits = np.ascontiguousarray(nwin, np.float32).view(np.uint32)
    out = []
    for j in range(bits.shape[0]):
        for r in range(j + 1):
            if np.array_equal(bits[r], bits[j]):
                out.append((r, False))
                break
            if np.array_equal(bits[r] ^ np.uint32(0x80000000), bits[j]):
                out.append((r, True))
                break
    return out


def l12_smem_image(c: dict) -> np.ndarray:
    """K7's shared-memory table image from the tables c (host_consts'
    entries), f32 [L12_FLOATS]: the unique rows of nwin_row_map(nwin)
    packed in order into the columns of ut [32, L12_COLS] (ut[k, q] =
    nwin[u_q, k]; the columns past the last unique row are zero), synth_d
    as it is, and per packed column q its store map: the FIFO column
    u_q, and the one row m != u_q that mirrors u_q, if any, with its
    sign (L12_NONE where there is none), and the sign of the mirror's dot
    over a row of +0.0 samples (a sum of signed zeros is -0.0 exactly
    when every term is, in any order).  The kernel computes the packed
    columns' dots and writes each mirrored row from them: a copy, or the
    negation where the dot is nonzero and not NaN, that signed zero for
    a row of +0.0 samples, else its own dot with the negated
    coefficients.  Raises if the table needs more packed columns or more
    mirrors than the kernel holds."""
    nwin = np.asarray(c["nwin"], np.float32)
    rows = nwin_row_map(nwin)
    unique = [j for j, (r, _) in enumerate(rows) if r == j]
    mirrors = {u: [(j, neg) for j, (r, neg) in enumerate(rows)
                   if r == u and j != u] for u in unique}
    if len(unique) > L12_COLS or any(len(m) > 1 for m in mirrors.values()):
        raise ValueError(f"K7 packs {L12_COLS} NWIN rows with one mirror "
                         f"each; the table has {len(unique)} unique rows")
    ut = np.zeros((32, L12_COLS), np.float32)
    cmap = np.full(L12_COLS, L12_NONE | (L12_NONE << 8), np.int32)
    signs = np.ascontiguousarray(nwin).view(np.uint32) >> 31
    for q, u in enumerate(unique):
        ut[:, q] = nwin[u]
        m, neg = mirrors[u][0] if mirrors[u] else (L12_NONE, False)
        zneg = m < L12_NONE and bool(signs[m].all())
        cmap[q] = (u | (m << 8) | (L12_NEG if neg else 0)
                   | (L12_ZERO_NEG if zneg else 0))
    out = np.concatenate([ut.ravel(), c["synth_d"].ravel(),
                          cmap.view(np.float32)]).astype(np.float32)
    assert out.size == L12_FLOATS
    return out


@functools.lru_cache(maxsize=None)
def host_consts(family: int = 0) -> dict:
    """Every constant of the family's step as numpy arrays (float32
    unless noted).

    cos36 [18,36] long IMDCT basis (m, p); c3 [18,36] the three
    interleaved 12-point IMDCTs folded into one basis, c3[k, w*12+p] =
    COS_N12[k//3, p] with w = k%3 (pdmp3.c:1678-1686);
    imdct_win [4,36] per block type; win2 [12] the short window; nwin
    [64,32] polyphase matrixing; synth_d [16,32] D window; inv [32,18]
    frequency-inversion sign; cs/ca [8] antialias; ratio_l/ratio_r [16]
    intensity ratios incl. the reference's out-of-bounds slots 8..15;
    pow43 [8207] |x|^(4/3); quarter_down/quarter_up [4];
    gain_quarter_true [640] the true 2^(-q/4) down to the f32 underflow
    point (95 entries are subnormal; the exact band-12 gain reads it);
    k0/k1 [2,64] the LSF intensity gain pairs by [iscale != 0, is_pos]
    (T.lsf_intensity_tables(), bit-identical to the JAX kernel's closed
    form); maps int16 (line_maps(family), the only family-dependent
    entry); inv_sqrt2, two32 and k32767 f32 scalars (0-d, so products
    with them stay in f32); granule_smem, the table image of
    granule_smem_image(); l12_smem, K7's, of l12_smem_image()."""
    cos12 = np.asarray(T.COS_N12, np.float32)
    c3 = np.zeros((18, 36), np.float32)
    for k in range(18):
        c3[k, (k % 3) * 12:(k % 3 + 1) * 12] = cos12[k // 3]
    ratio_l, ratio_r = T.intensity_ratio_tables()
    k0, k1 = T.lsf_intensity_tables()
    out = dict(
        cos36=np.asarray(T.COS_N36, np.float32),
        c3=c3,
        imdct_win=np.asarray(T.IMDCT_WIN, np.float32),
        win2=np.asarray(T.IMDCT_WIN[2][:12], np.float32),
        nwin=np.asarray(T.SYNTH_NWIN, np.float32),
        synth_d=np.asarray(T.SYNTH_D, np.float32).reshape(16, 32),
        inv=T.freq_inversion_sign(),
        cs=np.asarray(T.ANTIALIAS_CS, np.float32),
        ca=np.asarray(T.ANTIALIAS_CA, np.float32),
        ratio_l=np.asarray(ratio_l, np.float32),
        ratio_r=np.asarray(ratio_r, np.float32),
        pow43=np.asarray(T.POW43[:POW43_MAX + 1], np.float32),
        quarter_down=QUARTER_DOWN4,
        quarter_up=QUARTER_UP4,
        gain_quarter_true=np.asarray(T.GAIN_QUARTER_TRUE, np.float32),
        k0=np.asarray(k0, np.float32),
        k1=np.asarray(k1, np.float32),
        maps=line_maps(family),
        inv_sqrt2=INV_SQRT2_F32,
        two32=np.float32(2.0 ** 32),
        k32767=np.float32(32767.0),
    )
    out["granule_smem"] = granule_smem_image(out)
    out["l12_smem"] = l12_smem_image(out)
    return {k: np.array(v, order="C") for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def device_consts(device: str, family: int = 0) -> dict:
    """host_consts(family) as contiguous tensors on ``device`` (cached
    per device and family; read-only by convention)."""
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in host_consts(family).items()}
