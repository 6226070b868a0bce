"""Resampler quality sweep: the port's ``StreamResampler`` on the device
over every (from -> to) pair the serving pools offer.

    python -m pdmp3_tpu_torch.tools.resample_sweep
    python -m pdmp3_tpu_torch.tools.resample_sweep --pair 44100 48000 \\
        --device cpu

Counterpart of ``tools/resample_sweep.py``.  For each pair (the decoder
rates of MPEG-1 and LSF into 44.1 and 48 kHz):

- passband SNR against the ideal delayed sine at a low probe (1 kHz)
  and a high probe (0.35 x the narrower Nyquist): the Kaiser beta = 9
  prototype designs ~90 dB of stopband; the bar is
  ``tests/test_resample.py``'s 85 dB, and a pair below it fails the run;
- passband ripple: the largest RMS gain deviation, in dB, over a 10-tone
  comb spanning 0.04-0.40 of the narrower rate.

The pair's 12 probe signals run as the 12 streams of one resampler
(``StreamResampler(from, to, 12, 1, dtype=float32, device=...)``), fed
1152 samples a step as a pool feeds it (on the card one K8 launch a
block; ``blocks`` in the result counts them), on a common length (at least
0.6 s plus 4 blocks, and 16 blocks); the JAX tool ran each signal alone,
the ripple tones over exactly 16 blocks.  Writes
``build/torch_tools/resample_sweep.json`` unless ``--out`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from . import card, default_out, resolve_device, write_json

#: decoder rates (MPEG-1 + LSF) x common serving targets
PAIRS = sorted({(f, t)
                for f in (8000, 11025, 12000, 16000, 22050, 24000,
                          32000, 44100, 48000)
                for t in (44100, 48000) if f != t})
BLOCK = 1152
BAR_DB = 85.0
EDGE = 2000          # output samples dropped at each end (filter warm-up)
COMB = np.linspace(0.04, 0.40, 10)


def _delay(from_rate: int, to_rate: int) -> float:
    """The prototype's group delay in seconds."""
    up = to_rate // math.gcd(from_rate, to_rate)
    return (up * 24 - 1) / (2 * up * from_rate)


def _resample(from_rate: int, to_rate: int, x: np.ndarray, dev
              ) -> np.ndarray:
    """x f32 [S, N] (N a multiple of BLOCK) through one S-stream
    resampler, a block per step -> [S, n_out]."""
    from ..ops.resample import StreamResampler

    rs = StreamResampler(from_rate, to_rate, x.shape[0], 1,
                         dtype=torch.float32, device=dev)
    xt = torch.from_numpy(x).to(dev)[:, :, None]
    out = [rs(xt[:, i:i + BLOCK]) for i in range(0, x.shape[1], BLOCK)]
    return torch.cat(out, 1)[:, :, 0].cpu().numpy().astype(np.float64)


def sweep_pair(from_rate: int, to_rate: int, dev) -> dict:
    lo = min(from_rate, to_rate)
    hi_hz = 0.35 * lo
    n = max(int(from_rate * 0.6) // BLOCK * BLOCK + BLOCK * 4, BLOCK * 16)
    t = np.arange(n) / from_rate
    freqs = [1000.0, hi_hz] + [f * lo for f in COMB]
    x = np.stack([np.sin(2 * np.pi * f * t) for f in freqs]).astype(
        np.float32)
    y = _resample(from_rate, to_rate, x, dev)
    seg = slice(EDGE, y.shape[1] - EDGE)
    t2 = np.arange(y.shape[1]) / to_rate - _delay(from_rate, to_rate)
    snr = []
    for k in (0, 1):
        ref = np.sin(2 * np.pi * freqs[k] * t2)[seg]
        err = y[k, seg] - ref
        snr.append(float(10 * np.log10(np.mean(ref ** 2)
                                       / np.mean(err ** 2))))
    gains = np.sqrt(2.0) * np.sqrt(np.mean(y[2:, seg] ** 2, axis=1))
    return {"from": from_rate, "to": to_rate, "blocks": n // BLOCK,
            "snr_1k_db": snr[0], "snr_hi_db": snr[1], "hi_probe_hz": hi_hz,
            "ripple_db": float(np.max(np.abs(20 * np.log10(gains))))}


def run(pairs: list, dev) -> dict:
    rows = [sweep_pair(f, t, dev) for f, t in pairs]
    worst = min(min(r["snr_1k_db"], r["snr_hi_db"]) for r in rows)
    if worst < BAR_DB:
        bad = [r for r in rows if min(r["snr_1k_db"], r["snr_hi_db"])
               < BAR_DB]
        raise RuntimeError(f"passband SNR under {BAR_DB} dB: {bad}")
    return {"design": "Kaiser beta=9, 24 taps/phase (~90 dB stopband)",
            "device": str(dev), "card": card(dev), "pairs": rows,
            "worst_snr_db": worst,
            "blocks": sum(r["blocks"] for r in rows),
            "worst_ripple_db": max(r["ripple_db"] for r in rows),
            "test_bar_db": BAR_DB}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", type=int, nargs=2, action="append",
                    metavar=("FROM", "TO"),
                    help="sweep only this pair (repeatable; default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("resample_sweep.json"))
    args = ap.parse_args(argv)
    pairs = [tuple(p) for p in args.pair] if args.pair else PAIRS
    res = run(pairs, resolve_device(args.device))
    write_json(args.out, res)
    print(json.dumps({k: res[k] for k in ("worst_snr_db",
                                          "worst_ripple_db", "device")}
                     | {"pairs": len(res["pairs"])}))
    return res


if __name__ == "__main__":
    main()
