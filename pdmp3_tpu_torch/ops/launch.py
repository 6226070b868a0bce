"""How the port launches its hand-written kernels: one launch path, one
launch counter, the operand rules the kernels' copies share, and the
persistent kernels' instance map.

Each wrapper of ``ops/`` (``fused_step``, ``back_half``, ``frame_step``,
``l12_synth``, ``l12_requant``, ``l3_expand``, ``resample``,
``rounding``) checks its own operands, allocates its outputs and builds
its argument list, then calls ``launch`` once: the C entry point of the kernel library
(``_build.load``) on the operands' device and that device's current
stream, a RuntimeError with the library's error string on a nonzero
return, and, on success only, one more count of the kernel in
``LAUNCHES``.  A run zeroes the counts (``reset``), drives a path and
reads them back (``tools.launches``) to prove the path used the kernel;
CPU tensors take the plain versions and count nothing.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import _build

# every kernel's launch counter, each instance family apart: K1 and K2
# (family 0, fast and exact), K3 (the LSF families, fast and exact), the
# four again writing float PCM (instances 9-12), K4 (its raw sums
# apart), K6, K5 (MPEG-1 and LSF), K7 by precision and PCM type, K9, K8,
# K10
KERNELS = ("fused_granule", "fused_granule_exact", "fused_granule_lsf",
           "fused_granule_lsf_exact", "fused_granule_float",
           "fused_granule_float_exact", "fused_granule_lsf_float",
           "fused_granule_lsf_float_exact", "back_half", "back_half_raw",
           "rounding_sweep", "frame_fused", "frame_fused_lsf", "l12_synth",
           "l12_synth_exact", "l12_synth_float", "l12_synth_float_exact",
           "l12_requant", "resample", "l3_expand")
# launches of each kernel since the last reset
LAUNCHES = dict.fromkeys(KERNELS, 0)

# byte alignment the kernels need of each operand: bulk-copied ones 16,
# the 4-byte copies 4 (the persistent K1-K5 and K7; K9's body and side;
# K10's codes, and its 16-byte stores into ix)
BULK_ALIGN = {"ix": 16, "meta": 16, "store": 16, "v_blocks": 16, "pcm": 16,
              "xa": 16, "bt_eff": 16, "out": 16, "sb": 16, "body": 16,
              "side": 16, "codes": 4, "scf_l": 4, "scf_s": 4, "prev_lines": 4,
              "active": 4, "is_pos": 4}
# granule_launch_info's fields, in the order of pdmp3_granule_launch_info
LAUNCH_INFO = ("grid", "blocks_per_sm", "dynamic_smem_bytes", "registers",
               "local_bytes", "sm_count")


def reset() -> None:
    """Zero every kernel's launch count."""
    for k in KERNELS:
        LAUNCHES[k] = 0


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.pdmp3_cuda_error_string(rc).decode())


def launch(kernel: str, entry: str, device, *args) -> None:
    """Call the library's C entry point `entry` with args and, last, the
    current stream of `device`, with `device` made current (the entry
    point launches on the current device: its stream and per-device
    launch cache are that device's); then count one launch of `kernel`
    (a name of KERNELS).  RuntimeError with the library's error string
    when the entry point fails, and no count."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _raise_on(lib, rc, f"{kernel} launch")
    LAUNCHES[kernel] += 1


def check_operands(device, *want) -> None:
    """Raise ValueError unless each (name, tensor, shape, dtype) matches
    and is contiguous on device."""
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_bulk_alignment(**operands) -> None:
    """Raise ValueError unless each named operand (a key of BULK_ALIGN)
    starts on the byte alignment the kernels copy it with."""
    for name, t in operands.items():
        if t.data_ptr() % BULK_ALIGN[name]:
            raise ValueError(f"{name} must be {BULK_ALIGN[name]}-byte "
                             f"aligned for the kernels' copies (address "
                             f"{t.data_ptr():#x})")


def launch_instance(exact: bool = False, family: int = 0,
                    frame: bool = False, back_half: bool = False,
                    raw: bool = False, float_pcm: bool = False,
                    layer: int = 3) -> int:
    """The persistent kernel instance of pdmp3_granule_launch_info: 0 K1,
    1 K2, 2 K3 fast, 3 K3 exact (family 1 or 2), 4 K5 MPEG-1, 5 K5 LSF
    (frame; fast only), 6 K4 fast, 7 K4 exact, 8 K4 fast raw sums
    (back_half; K4 takes post-antialias spectra of any family, so no
    family; exact K4 always returns raw sums), 9-12 K1, K2, K3 fast and
    K3 exact writing float PCM (float_pcm; granule steps only); with
    layer 1 or 2, K7, the Layer I/II synthesis (csrc/l12_synth.cu):
    13 + 4 (Layer II) + 2 (float_pcm) + 1 (exact).  ValueError for any
    other combination."""
    if layer in (1, 2):
        if family or frame or back_half or raw:
            raise ValueError("K7, the Layer I/II synthesis, takes no "
                             "family, frame, back half or raw sums")
        return 13 + 4 * (layer == 2) + 2 * bool(float_pcm) + int(exact)
    if layer != 3:
        raise ValueError(f"layer must be 1, 2 or 3, got {layer!r}")
    if family not in (0, 1, 2):
        raise ValueError(f"family must be 0, 1 or 2, got {family!r}")
    if frame and exact:
        raise ValueError("K5, the frame kernel, is fast only")
    if back_half and (frame or family):
        raise ValueError("K4, the back half, takes no frame and no family")
    if raw and not back_half:
        raise ValueError("raw sums come from K4, the back half, only")
    if float_pcm and (frame or back_half):
        raise ValueError("float PCM instances are granule steps (K1-K3)")
    if back_half:
        return 7 if exact else 8 if raw else 6
    if frame:
        return 4 + (family != 0)
    return 9 * float_pcm + 2 * (family != 0) + int(exact)


def granule_launch_info(device, exact: bool = False, family: int = 0,
                        frame: bool = False, back_half: bool = False,
                        raw: bool = False, float_pcm: bool = False,
                        layer: int = 3) -> dict:
    """The launch geometry of the persistent kernel that runs a step of
    `family` in that precision (K1, K2 or K3, instances 9-12 with
    float_pcm; K5 when frame; K4 when back_half, instance 8 with raw; K7
    with layer 1 or 2) on a CUDA device, from the kernel library: the
    persistent grid (SM count x resident blocks per SM; min(B, grid)
    blocks launch), blocks per SM, dynamic shared memory per block,
    registers and local (spill) bytes per thread, SM count.  The
    arguments are checked (launch_instance) before the library is
    loaded."""
    instance = launch_instance(exact, family, frame, back_half, raw,
                               float_pcm, layer)
    lib = _build.load()
    info = (C.c_int * len(LAUNCH_INFO))()
    with torch.cuda.device(torch.device(device)):
        rc = lib.pdmp3_granule_launch_info(instance, info)
    _raise_on(lib, rc, "granule launch info")
    return dict(zip(LAUNCH_INFO, info))
