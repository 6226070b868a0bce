"""Build the port's copy of the native host library with g++.

Invoked on demand by pdmp3_tpu_torch.host (ctypes loader); builds
``build/torch_host/libpdmp3host_torch.so`` from this package's own
``host/src`` when a source is newer than the library.  -ffp-contract=off
is load-bearing: FMA contraction would break the scalar DSP's bit parity
with the reference decoder.

The library is linked to a temporary path and moved into place with
``os.replace``: several processes (test workers) may start the same
build at once, and none of them may load a half-written library.  The
generated table include ``src/gen_tables.inc`` is part of the sources;
the build raises if it is missing.
"""
from __future__ import annotations

import os
import subprocess

HOST_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HOST_DIR))
BUILD_DIR = os.path.join(REPO, "build", "torch_host")
LIB = os.path.join(BUILD_DIR, "libpdmp3host_torch.so")

SRCS = ["tables.cc", "frame.cc", "dsp.cc", "api.cc"]
CXXFLAGS = ["-std=c++17", "-O3", "-Wall", "-Wextra", "-fPIC", "-pthread",
            "-ffp-contract=off", "-fno-fast-math"]


def _mtime(path: str) -> float:
    return os.path.getmtime(path) if os.path.exists(path) else -1.0


def ensure_built(verbose: bool = False) -> str:
    """Path of the host library, compiling it if a source is newer."""
    src_dir = os.path.join(HOST_DIR, "src")
    inc = os.path.join(src_dir, "gen_tables.inc")
    if not os.path.exists(inc):
        raise FileNotFoundError(f"{inc} is missing: it is a tracked source "
                                "of the host library")
    srcs = [os.path.join(src_dir, s) for s in SRCS]
    deps = srcs + [inc, os.path.join(src_dir, "internal.h"),
                   os.path.join(HOST_DIR, "include", "pdmp3.h")]
    built = _mtime(LIB)
    if built >= 0 and all(_mtime(d) <= built for d in deps):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = ["g++", *CXXFLAGS, "-shared", "-o", tmp, *srcs]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB


if __name__ == "__main__":
    print(ensure_built(verbose=True))
