"""Program-material generators for real-encoder conformance testing.

Signal classes chosen to steer a psychoacoustic encoder's block-switch
decisions: ``transient`` (clicks + gated noise bursts over a chirp)
forces short/mixed blocks; ``tonal`` (stationary sines) keeps long
blocks with heavy scalefactor reuse; ``sweep`` (full-band chirp)
exercises every scalefactor band.  Used by tests/test_real_encoder.py
and tools/soak.py --real-encoder.
"""
from __future__ import annotations

import numpy as np


def make_pcm(kind: str, rate: int, channels: int, seconds: float = 1.5,
             seed: int = 0) -> np.ndarray:
    """Interleaved f32 program material (see module docstring)."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    if kind == "tonal":
        sig = (0.4 * np.sin(2 * np.pi * 440 * t)
               + 0.25 * np.sin(2 * np.pi * 1873 * t + 0.3)
               + 0.1 * np.sin(2 * np.pi * 0.21 * rate * t))
    elif kind == "sweep":
        f0, f1 = 30.0, 0.45 * rate
        phase = 2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * seconds))
        sig = 0.6 * np.sin(phase)
    elif kind == "transient":
        sig = 0.35 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
        sig[:: rate // 11] = 0.95                     # hard clicks
        gate = np.sin(2 * np.pi * 4 * t) > 0.85       # noise bursts
        sig = sig + 0.4 * rng.standard_normal(n) * gate
    elif kind == "noise":
        # full-band white noise: worst case for the psychoacoustic
        # model's bit allocation (max scalefactor churn, big count1)
        sig = 0.5 * rng.standard_normal(n)
    elif kind == "speech":
        # speech-like envelope: pitch-pulsed formant tones with
        # syllable-rate amplitude gating and inter-word silence
        f0 = 120 + 40 * np.sin(2 * np.pi * 2.7 * t)
        phase = 2 * np.pi * np.cumsum(f0) / rate
        sig = (0.5 * np.sin(phase) + 0.3 * np.sin(2 * phase + 0.4)
               + 0.15 * np.sin(3.3 * phase))
        syll = np.clip(np.sin(2 * np.pi * 3.1 * t + 0.5), 0, None) ** 0.5
        words = (np.sin(2 * np.pi * 0.9 * t) > -0.4).astype(np.float32)
        sig = sig * syll * words + 0.01 * rng.standard_normal(n)
    elif kind == "silence":
        # digital black: every granule hits the part2_3_length==0 /
        # all-zero-spectrum paths and LAME's minimum frame fill
        sig = np.zeros(n)
    elif kind == "clipped":
        # hard-clipped program: dense harmonics + sustained full-scale
        # plateaus (drives overdriven requantize outputs and the PCM
        # clip/saturation paths on the decode side)
        sig = np.clip(2.5 * np.sin(2 * np.pi * 330 * t)
                      + 1.2 * np.sin(2 * np.pi * 2470 * t), -0.999, 0.999)
    elif kind == "dc":
        # DC-offset material: nonzero mean plus low-frequency content —
        # encoders high-pass this asymmetrically, stressing band-0
        # scalefactors and the polyphase filterbank's DC leakage
        sig = (0.4 + 0.3 * np.sin(2 * np.pi * 11 * t)
               + 0.2 * np.sin(2 * np.pi * 700 * t))
    else:
        raise ValueError(kind)
    sig = sig.astype(np.float32)
    if channels == 1:
        return sig
    other = np.roll(sig, rate // 50) * 0.8 + 0.05 * rng.standard_normal(n)
    return np.stack([sig, other.astype(np.float32)], -1).reshape(-1)
