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
einsum) with no Pallas kernel; here it is plain PyTorch: one gather and
one multiply-add per tap, summed from the first tap on, so a streamed
output equals the one-shot output bit for bit.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


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
        between steps with the phase)."""
        x = torch.cat([self.carry, pcm.to(torch.float32)], 1)
        n_in = int(pcm.shape[1])
        # the outputs whose window fits in the carried and new samples
        n_out = (n_in * self.up - self.phase + self.down - 1) // self.down
        ph = self.phase + np.arange(n_out, dtype=np.int64) * self.down
        m = torch.from_numpy(ph // self.up).to(self.device)
        p = torch.from_numpy(ph % self.up).to(self.device)
        y = _resample_block(x, m, p, self.H, self.taps)
        self.phase = int(self.phase + n_out * self.down - n_in * self.up)
        self.carry = x[:, x.shape[1] - (self.taps - 1):].contiguous()
        if self.dtype == torch.int16:
            return torch.round(y).clamp(-32768, 32767).to(torch.int16)
        return y.to(self.dtype)
