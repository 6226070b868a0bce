"""Build and bind the port's CUDA kernels.

``nvcc`` compiles every ``pdmp3_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface, ``build/torch_kernels/
libpdmp3_torch_kernels.so``, which ``ctypes`` loads.  The library is
rebuilt at first use whenever a hash of the sources and flags changes
(the hash is stored beside it), so a fresh checkout builds it on its
first CUDA call.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes as C
import functools
import glob
import hashlib
import os
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v"]


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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(LOG, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, LIB)
    with open(stamp, "w") as f:
        f.write(digest)
    return LIB


@functools.lru_cache(maxsize=1)
def load() -> C.CDLL:
    """The built library with every entry point's ctypes signature."""
    lib = C.CDLL(ensure_built())
    fn = lib.pdmp3_fused_granule
    # 9 operand pointers, 15 table pointers, B, gr1, bug_compat, stream
    fn.argtypes = [C.c_void_p] * 24 + [C.c_int] * 3 + [C.c_void_p]
    fn.restype = C.c_int
    lib.pdmp3_cuda_error_string.argtypes = [C.c_int]
    lib.pdmp3_cuda_error_string.restype = C.c_char_p
    return lib
