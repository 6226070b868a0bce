"""The reference's three float64 rounding points, and the sweep that
proves the exact kernel's copies of them over every f32 input.

The reference decoder widens to double at three places per sample:

- ``ms_f64``: the MS butterfly, ``fl32(f64(m) * C_INV_SQRT_2)`` on
  ``m = fl32(l +- r)`` (pdmp3.c:1923-1925);
- ``uq_f64``: the short-block intensity quirk, which assigns
  ``trunc(l)`` through an unsigned int, ``fl32(floor_mod(trunc(f64(l)),
  2^32))`` (pdmp3.c:2212-2213);
- ``qz_f64``: the final quantize, ``trunc(f64(s) * 32767)`` with
  cvttsd2si semantics: NaN and values outside int32 become INT32_MIN,
  which the clip turns into -32767 (pdmp3.c:2028-2031).

Here they are plain tensor functions in native float64.  The JAX
package emulates them with Dekker/Veltkamp f32 constructions because
its TPU has no f64 (``pallas_step._k_ms_exact`` / ``_k_uq_exact`` /
``_k_qz_exact``); both PyTorch and the H100 have f64, so the port needs
none of that.

The exact CUDA kernel calls the same three points as ``__device__``
functions (``csrc/rounding.cuh``).  ``sweep`` runs those device
functions over all 2^32 f32 bit patterns on the card (the kernel
``csrc/rounding_sweep.cu``, counterpart of the TPU sweep
``tools/prove_on_tpu.py:_device_fn``) and compares each chunk bitwise
with the plain functions below, NaNs canonicalised.  Unlike the TPU
sweep it masks nothing: the card keeps subnormals.  One launch
(``rounding_sweep_all``) covers a chunk for all three constructions,
generating the inputs once.
"""
from __future__ import annotations

import time

import torch

from .consts import INV_SQRT2_F64
from .launch import launch

# the constructions in the order of the kernel's output rows
# (csrc/rounding_sweep.cu)
CONSTRUCTIONS = ("ms", "uq", "qz")

_F32, _F64 = torch.float32, torch.float64


def ms_f64(m: torch.Tensor) -> torch.Tensor:
    """fl32(f64(m) * C_INV_SQRT_2) for f32 m (the caller rounds l +- r
    to f32 first, as C does)."""
    return (m.to(_F64) * INV_SQRT2_F64).to(_F32)


def uq_f64(l: torch.Tensor) -> torch.Tensor:
    """fl32(floor_mod(trunc(f64(l)), 2^32)) for f32 l.

    Written as t - floor(t / 2^32) * 2^32: every step is exact in f64
    for an f32 t.  -0.0 gives +0.0, as the reference's integer round
    trip does (the final + 0.0 fixes it; torch.remainder would keep
    -0.0)."""
    t = torch.trunc(l.to(_F64))
    r = t - torch.floor(t * 2.0 ** -32) * 2.0 ** 32
    return (r + 0.0).to(_F32)


def qz_f64(s: torch.Tensor) -> torch.Tensor:
    """trunc(f64(s) * 32767) clipped to +-32767, with NaN, t < -2^31 and
    t > 2^31 - 1 giving -32767; returned as f32 (the sign of a zero is
    kept, as the f64 truncation gives it)."""
    scaled = s.to(_F64) * 32767.0
    t = torch.trunc(scaled)
    oob = torch.isnan(scaled) | (t < -2147483648.0) | (t > 2147483647.0)
    q = torch.where(oob, torch.full_like(t, -32767.0),
                    t.clamp(-32767.0, 32767.0))
    return q.to(_F32)


PLAIN = {"ms": ms_f64, "uq": uq_f64, "qz": qz_f64}


def chunk_inputs(base: int, n: int, device) -> torch.Tensor:
    """The n f32 values whose bit patterns are base, base+1, ... (mod
    2^32)."""
    bits = (torch.arange(n, dtype=torch.int64, device=device) + base) \
        & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(_F32)


def rounding_sweep_all(base: int, n: int, device) -> torch.Tensor:
    """f32 [3, n]: row c is construction c (CONSTRUCTIONS order) of
    chunk_inputs(base, n), all three from one launch on a CUDA device
    (rows of a [3, row_stride(n)] buffer); the plain versions on the
    CPU."""
    device = _check_chunk(base, n, device)
    if device.type == "cpu":
        x = chunk_inputs(base, n, device)
        return torch.stack([PLAIN[c](x) for c in CONSTRUCTIONS])
    ld = row_stride(n)
    out = torch.empty((len(CONSTRUCTIONS), ld), dtype=_F32, device=device)
    launch("rounding_sweep", "pdmp3_rounding_sweep", device, base,
           out.data_ptr(), n, ld)
    return out[:, :n]


def row_stride(n: int) -> int:
    """Floats between rounding_sweep_all's rows: n rounded up to the
    kernel's vector of 4, so every row starts 16-byte aligned."""
    return -(-n // 4) * 4


def _check_chunk(base: int, n: int, device) -> torch.device:
    if not 0 <= base < 2 ** 32 or not 0 < n <= 2 ** 32 - base:
        raise ValueError(f"chunk [{base}, {base} + {n}) is outside 2^32")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rounding sweep for {device}")
    return device


def mismatches(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """0-d int64: elements whose bits differ, NaN == NaN whatever the
    payload."""
    same = (got.view(torch.int32) == want.view(torch.int32)) \
        | (torch.isnan(got) & torch.isnan(want))
    return (~same).sum()


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """0-d f64: the largest |got - want| over the elements finite in
    both."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    d = (got.to(_F64) - want.to(_F64)).abs()
    return torch.where(fin, d, torch.zeros_like(d)).max()


def sweep(chunk_bits: int = 24, device="cuda", chunks=None) -> dict:
    """Compare the device functions with the plain f64 functions over
    every f32 bit pattern, in 2^chunk_bits chunks (or only the chunk
    indices given in ``chunks``), all three constructions from one
    rounding_sweep_all launch per chunk.  Returns the chunks that
    mismatched in any construction, the mismatching inputs and the
    largest error over inputs finite on both sides per construction, and
    the time taken; one synchronisation at the end."""
    n = 1 << chunk_bits
    n_chunks = 1 << (32 - chunk_bits)
    todo = range(n_chunks) if chunks is None else list(chunks)
    device = torch.device(device)
    counts, errs = [], []
    t0 = time.perf_counter()
    for c in todo:
        got = rounding_sweep_all(c * n, n, device)
        x = chunk_inputs(c * n, n, device)
        want = [PLAIN[name](x) for name in CONSTRUCTIONS]
        counts.append(torch.stack([mismatches(g, w)
                                   for g, w in zip(got, want)]))
        errs.append(torch.stack([max_abs_err(g, w)
                                 for g, w in zip(got, want)]))
    k = len(CONSTRUCTIONS)
    counts = torch.stack(counts).cpu().tolist() if counts else [[0] * k]
    err = torch.stack(errs).amax(0).tolist() if errs else [0.0] * k
    seconds = time.perf_counter() - t0
    bad = [c for c, m in zip(todo, counts) if any(m)]
    return {"constructions": list(CONSTRUCTIONS), "chunk_bits": chunk_bits,
            "chunks_swept": len(errs), "inputs_swept": len(errs) * n,
            "mismatching_chunks": bad,
            "mismatching_inputs": int(sum(map(sum, counts))),
            "max_abs_err": max(err),
            "by_construction": {
                name: {"mismatching_inputs": int(sum(m[i] for m in counts)),
                       "max_abs_err": err[i]}
                for i, name in enumerate(CONSTRUCTIONS)},
            "seconds": seconds}
