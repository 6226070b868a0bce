"""Build and bind the port's CUDA kernels.

``nvcc`` compiles each ``pdmp3_tpu_torch/csrc/*.cu`` to an object, all
sources at once in parallel processes, and links them into one shared
library with a plain C interface, ``build/torch_kernels/
libpdmp3_torch_kernels.so``, which ``ctypes`` loads.  The library is
rebuilt at first use whenever a hash of the sources (headers included)
and flags changes (the hash is stored beside it), so a fresh checkout
builds it on its first CUDA call.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes as C
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
SRC_DIR = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(REPO, "build", "torch_kernels")
LIB = os.path.join(BUILD_DIR, "libpdmp3_torch_kernels.so")
LOG = os.path.join(BUILD_DIR, "build.log")

# -fmad=false: no FMA contraction (the kernels round where their plain
# PyTorch versions round).  No --use_fast_math: it turns on
# flush-to-zero, and the band-12 carry reads denormal float bits.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-ftz=false",
              "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v"]


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "CUDA kernels are built from source at first use")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def ensure_built() -> str:
    """Path of the kernel library, compiling it if the sources changed."""
    digest = _digest()
    stamp = LIB + ".sha256"
    if os.path.exists(LIB) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
            for s, o in zip(cus, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    results = [(cmd, p.communicate()[0], p.returncode)
               for cmd, p in zip(cmds, procs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", tmp, *objs]
    if all(rc == 0 for _, _, rc in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.stdout + proc.stderr, proc.returncode))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    with open(LOG, "w") as f:
        for cmd, out, _ in results:
            f.write(" ".join(cmd) + "\n" + out)
    bad = [(cmd, out, rc) for cmd, out, rc in results if rc != 0]
    if bad:
        cmd, out, rc = bad[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, LIB)
    with open(stamp, "w") as f:
        f.write(digest)
    return LIB


def ptxas_summary(log: str) -> list[str]:
    """Registers, shared memory and spills of each kernel instance from
    nvcc's -Xptxas -v report (the text of LOG): a template instance as
    name<args> (a type argument by its C name: resample_kernel<short,
    float,2,24>), a kernel without template arguments by its name."""
    types = {"s": "short", "f": "float", "i": "int"}
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"(?:I((?:[a-z]|L[a-z]\d+E)+)E)?", ln)
        if m:
            args = re.findall(r"L([a-z])(\d+)E|([a-z])", m.group(2) or "")
            name = m.group(1) + ("<" + ",".join(
                types.get(ty, ty) if ty else
                ("true" if v == "1" else "false") if t == "b" else v
                for t, v, ty in args) + ">" if args else "")
        elif "spill stores" in ln:
            out.append(f"{name}: {ln.split(',', 1)[1].strip()}")
        elif "registers" in ln and out:
            out[-1] += "; " + ln.split(":", 1)[1].strip()
    return out


@functools.lru_cache(maxsize=1)
def load() -> C.CDLL:
    """The built library with every entry point's ctypes signature."""
    lib = C.CDLL(ensure_built())
    ptr, i32, i64 = C.c_void_p, C.c_int, C.c_longlong
    sigs = {
        # 10 operand pointers, the table array, B, gr1, bug_compat,
        # exact, lsf, float_pcm
        "pdmp3_fused_granule": [ptr] * 11 + [i32] * 6 + [ptr],
        # 10 operand pointers, the table array, B, ng, parities,
        # bug_compat, lsf
        "pdmp3_frame_fused": [ptr] * 11 + [i32] * 5 + [ptr],
        # 7 operand pointers, the table array, B, exact, raw
        "pdmp3_back_half": [ptr] * 8 + [i32] * 3 + [ptr],
        # instance, the int[6] out array
        "pdmp3_granule_launch_info": [i32, ptr],
        # base, out, n, row stride
        "pdmp3_rounding_sweep": [C.c_uint32, ptr, C.c_longlong,
                                 C.c_longlong, ptr],
        # sb, nch (pointer, element size, stride), active (the same), v,
        # pcm, the table image, B, S, exact, float_pcm
        "pdmp3_l12_synth": [ptr, ptr, i32, i64, ptr, i32, i64, ptr, ptr, ptr]
        + [i32] * 4 + [ptr],
        # body, side, geom, sb, the class tables cd, ci, scf, slot-frames,
        # S
        "pdmp3_l12_requant": [ptr] * 7 + [i64, i32, ptr],
        # codes, starts, esc, its length, ix, rows
        "pdmp3_l3_expand": [ptr, ptr, ptr, i64, ptr, i64, ptr],
        # carry, in, its stream stride, in_f32, H, new carry, out,
        # out_f32, B, N, C, taps, up, down, phase, n_out, p_first, p_end,
        # p_chunk, chunks, hstride, win, bulk, shared bytes
        "pdmp3_resample": [ptr, ptr, i64, i32, ptr, ptr, ptr] + [i32] * 17
        + [ptr],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = C.c_int
    lib.pdmp3_cuda_error_string.argtypes = [C.c_int]
    lib.pdmp3_cuda_error_string.restype = C.c_char_p
    return lib
