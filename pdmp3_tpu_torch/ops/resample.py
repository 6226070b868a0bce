"""Batched streaming polyphase resampler (a serving option beyond the
reference, which does not resample).

Counterpart of ``pdmp3_tpu/ops/resample.py``: a Kaiser-windowed sinc
filter bank split into phases, applied to ``[B, N, C]`` PCM blocks of a
rate-homogeneous pool, with the last taps-1 input samples of every
stream carried between blocks as device state, like the decoder's
overlap and FIFO carries.

Rational ratio L/M (44,100 -> 48,000 is 160/147): output j of a step
reads the input window at m_j with phase p_j, (m_j, p_j) = divmod(phase0
+ j*M, L).  The running phase is a host integer, so a step's output
length is known before anything runs on the device.

The JAX package computes a block as XLA ops (a window gather and an
einsum) with no Pallas kernel.  Here ``resample_block`` has two
implementations with one contract: ``resample_block_ref``, plain PyTorch
(the carry and the block concatenated, one gather and one multiply-add
per tap, summed from the first tap on), the path for CPU tensors and
the reference the tests hold the kernel against; and K8, the
hand-written CUDA kernel of ``csrc/resample.cu``, launched for CUDA
tensors, which stages each stream's window in shared memory (by bulk
copy where the block is 16-byte aligned) and walks the window starts
from the host's integer phase: a thread takes four consecutive starts
and every output that starts there, their windows in registers.  Both sum in the same
order, so a streamed output equals the one-shot output bit for bit, and
the kernel equals the plain version.  There is no fallback between
them: a CUDA tensor either runs the kernel or raises.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .launch import launch

# the shared memory a block of K8 may take (an H100's 227 KB), the input
# samples a channel of the window one of its units stages when a
# stream's window is split into chunks, and the window positions a
# thread of K8 takes at once (csrc/resample.cu kRsRun)
MAX_SMEM_BYTES = 232448
K8_WINDOW = 4096
K8_RUN = 4


def k8_period(down: int) -> int:
    """The window positions after which K8's output phases repeat: a
    multiple of down, at least K8_RUN (csrc/resample.cu rs_period)."""
    return down if down >= K8_RUN else down * -(-K8_RUN // down)


def k8_hstride(taps: int) -> int:
    """K8's row stride of the filter bank in shared memory: taps rounded
    up to a multiple of 4, made an odd number of float4s (rows of
    different phases then start in different banks)."""
    t4 = -(-taps // 4) * 4
    return t4 + 4 if (t4 // 4) % 2 == 0 else t4


def k8_geometry(up: int, down: int, taps: int, channels: int, n_out: int,
                n_in: int, phase: int, in_bytes: int = 2,
                bulk: bool = False) -> dict:
    """K8's launch geometry for a block of n_in samples whose n_out
    outputs start at phase: the window positions [p_first, p_end) of the
    outputs (output j starts at (phase + j * down) // up); their split
    into `chunks` chunks of p_chunk positions (one chunk, the whole x,
    when carry and block fit K8_WINDOW samples a channel; else chunks
    whose windows do, a multiple of k8_period positions each); the
    staged window's capacity `win` (samples a channel); `bulk`, whether
    the blocks are staged by bulk copy (asked for by the caller, who
    knows their alignment, and only with one chunk); `hstride`; and
    `smem`, the shared memory a block, bytes (csrc/resample.cu RsSmem):
    the bank f32 [up][hstride], the class table, two stages of the raw
    block in the bulk path, the window f32 [win][C], two mbarriers."""
    K = taps - 1
    if n_out:
        p_first = phase // up
        p_end = (phase + (n_out - 1) * down) // up + 1
    else:
        p_first = p_end = 0
    L = k8_period(down)
    span = p_end - p_first
    if K + n_in <= K8_WINDOW:
        p_chunk, chunks = max(span, 1), 1
    else:
        p_chunk = max(L, (K8_WINDOW - K) // L * L)
        chunks = max(1, -(-span // p_chunk))
    win = K + n_in if chunks == 1 else p_chunk + K
    bulk = bool(bulk and chunks == 1 and n_in > 0)
    hstride = k8_hstride(taps)
    classes = -(-L // K8_RUN)

    def align(x, a):
        return -(-x // a) * a
    stage = align(4 * up * hstride + 8 * classes, 16)
    stage_bytes = align(n_in * channels * in_bytes, 16) if bulk else 0
    bar = align(stage + 2 * stage_bytes + 4 * channels * win, 8)
    return dict(p_first=p_first, p_end=p_end, p_chunk=p_chunk,
                chunks=chunks, win=win, bulk=bulk, hstride=hstride,
                smem=bar + 16)


@functools.lru_cache(maxsize=None)
def polyphase_filter(up: int, down: int, taps_per_phase: int = 24,
                     beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype split into ``up`` phases:
    [up, taps_per_phase] float32, unit DC gain per phase."""
    ntaps = up * taps_per_phase
    cutoff = min(1.0 / up, 1.0 / down)  # of Nyquist*up
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(ntaps, beta)
    h *= up / h.sum()
    # phase p holds taps h[p], h[p+up], ... (standard polyphase split);
    # normalize each phase to unit DC so constant inputs stay constant
    ph = h.reshape(taps_per_phase, up).T.copy()   # [up, taps]
    ph /= ph.sum(axis=1, keepdims=True) * np.float64(1.0)
    return np.ascontiguousarray(ph[:, ::-1]).astype(np.float32)


def _resample_block(x, m_idx, p_idx, H, taps: int):
    """x f32 [B, Nin+taps-1, C] (carry prefix + this block); m_idx /
    p_idx int64 [n_out] (window starts and phases); H f32 [up, taps].
    Returns y f32 [B, n_out, C]: sum over t of x[:, m + t] * H[p, t],
    accumulated from t = 0."""
    hg = H[p_idx]                                  # [n_out, taps]
    y = x[:, m_idx] * hg[None, :, 0, None]
    for t in range(1, taps):
        y = y + x[:, m_idx + t] * hg[None, :, t, None]
    return y


def resample_block(carry, pcm, phase: int, up: int, down: int, H,
                   n_out: int, dtype=torch.int16):
    """One block of B streams: carry f32 [B, taps-1, C] (contiguous),
    pcm int16 or f32 [B, N, C] (each stream's N x C samples contiguous),
    the running phase in 1/up input samples, H f32 [up, taps], and the
    n_out outputs the phase gives.  Returns (y [B, n_out, C] in dtype,
    int16 rounded half to even and clamped; the new carry f32 [B,
    taps-1, C], the last taps-1 samples of the carry and block).  CPU
    tensors take the plain version; CUDA tensors launch K8 (int16 or f32
    in and out)."""
    B, N, C = pcm.shape
    taps = H.shape[1]
    if (tuple(carry.shape) != (B, taps - 1, C) or carry.dtype != torch.float32
            or tuple(H.shape) != (up, taps) or H.dtype != torch.float32):
        raise ValueError(f"carry {carry.dtype} {tuple(carry.shape)} and H "
                         f"{H.dtype} {tuple(H.shape)} do not fit pcm "
                         f"{tuple(pcm.shape)} at up = {up}")
    if carry.device != pcm.device or H.device != pcm.device:
        raise ValueError(f"carry on {carry.device} and H on {H.device}, "
                         f"pcm on {pcm.device}")
    if pcm.device.type == "cpu":
        return resample_block_ref(carry, pcm, phase, up, down, H, n_out,
                                  dtype)
    if pcm.device.type != "cuda":
        raise ValueError(f"no resampler for {pcm.device}")
    f32 = {torch.int16: 0, torch.float32: 1}
    if pcm.dtype not in f32 or dtype not in f32 or C not in (1, 2):
        raise ValueError(f"K8 takes one or two channels of int16 or f32 "
                         f"PCM in and out, got {C} of {pcm.dtype} -> "
                         f"{dtype}")
    # the kernel reads sample n, channel c of stream b at b * stride(0) +
    # n * C + c: the strides of an empty block, or of a dimension of one
    # element, are never used
    if ((N and ((C > 1 and pcm.stride(2) != 1)
                or (N > 1 and pcm.stride(1) != C)))
            or not (carry.is_contiguous() and H.is_contiguous())):
        raise ValueError("pcm needs contiguous channels and samples, carry "
                         "and H contiguous")
    if phase + n_out * down >= 2 ** 31:
        raise ValueError("K8 indexes a block in int32: phase + n_out x down "
                         "must stay below 2^31")
    # the bulk copies need each stream's block 16-byte aligned in address
    # and size; other blocks are staged by plain loads in the kernel
    es = pcm.element_size()
    aligned = (pcm.data_ptr() % 16 == 0 and (pcm.stride(0) * es) % 16 == 0
               and (N * C * es) % 16 == 0)
    geo = k8_geometry(up, down, taps, C, n_out, N, int(phase), es, aligned)
    if geo["smem"] > MAX_SMEM_BYTES:
        raise ValueError(f"{up} x {taps} taps and a window of {C} channels "
                         f"at {up}/{down} need {geo['smem']} B of K8's "
                         "shared memory")
    y = torch.empty((B, n_out, C), dtype=dtype, device=pcm.device)
    new_carry = torch.empty_like(carry)
    if B == 0:
        return y, new_carry
    launch("resample", "pdmp3_resample", pcm.device, carry.data_ptr(),
           pcm.data_ptr(), pcm.stride(0), f32[pcm.dtype], H.data_ptr(),
           new_carry.data_ptr(), y.data_ptr(), f32[dtype], B, N, C, taps,
           up, down, int(phase), n_out, geo["p_first"], geo["p_end"],
           geo["p_chunk"], geo["chunks"], geo["hstride"], geo["win"],
           int(geo["bulk"]), geo["smem"])
    return y, new_carry


def resample_block_ref(carry, pcm, phase: int, up: int, down: int, H,
                       n_out: int, dtype=torch.int16):
    """Plain PyTorch version of resample_block (same arguments and
    results, same summation order)."""
    taps = H.shape[1]
    x = torch.cat([carry, pcm.to(torch.float32)], 1)
    ph = phase + np.arange(n_out, dtype=np.int64) * down
    m = torch.from_numpy(ph // up).to(x.device)
    p = torch.from_numpy(ph % up).to(x.device)
    y = _resample_block(x, m, p, H, taps)
    new_carry = x[:, x.shape[1] - (taps - 1):].contiguous()
    if dtype == torch.int16:
        return torch.round(y).clamp(-32768, 32767).to(torch.int16), new_carry
    return y.to(dtype), new_carry


class StreamResampler:
    """Streaming rational resampler over batched PCM steps.

    Feed successive ``[B, N, C]`` int16 (or float) PCM blocks of a
    rate-homogeneous pool, as tensors on ``device``; returns ``[B, n_out,
    C]`` blocks in ``dtype`` (int16: rounded half to even and clipped),
    stitched without a gap.  State per stream: the last taps-1 input
    samples (``carry``, on the device); the running ``phase`` (in 1/up
    input samples) is a host integer.  ``carry`` (numpy or tensor [B,
    taps-1, C]) and ``phase`` restore a resampler's state, e.g. the JAX
    package's (its ``carry`` and ``phase`` attributes), which this one
    then continues."""

    def __init__(self, from_rate: int, to_rate: int, batch: int,
                 channels: int = 2, taps_per_phase: int = 24,
                 dtype=torch.int16, *, device, carry=None,
                 phase: int = 0):
        g = math.gcd(from_rate, to_rate)
        self.up = to_rate // g
        self.down = from_rate // g
        self.taps = taps_per_phase
        self.device = torch.device(device)
        self.H = torch.from_numpy(polyphase_filter(
            self.up, self.down, taps_per_phase)).to(self.device)
        self.phase = int(phase)
        if carry is None:
            self.carry = torch.zeros((batch, self.taps - 1, channels),
                                     dtype=torch.float32, device=self.device)
        else:
            self.carry = torch.from_numpy(
                np.array(carry, np.float32)).to(self.device)
            if tuple(self.carry.shape) != (batch, self.taps - 1, channels):
                raise ValueError(f"carry {tuple(self.carry.shape)}, want "
                                 f"{(batch, self.taps - 1, channels)}")
        self.dtype = dtype

    def __call__(self, pcm):
        """pcm [B, N, C] -> [B, n_out, C] (n_out varies by at most one
        between steps with the phase).  K8 on CUDA tensors
        (``resample_block``), one launch a call."""
        n_in = int(pcm.shape[1])
        # the outputs whose window fits in the carried and new samples
        n_out = (n_in * self.up - self.phase + self.down - 1) // self.down
        y, self.carry = resample_block(self.carry, pcm, self.phase, self.up,
                                       self.down, self.H, n_out, self.dtype)
        self.phase = int(self.phase + n_out * self.down - n_in * self.up)
        return y
