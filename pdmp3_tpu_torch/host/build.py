"""Build the port's copy of the native host library and its drivers with g++.

Invoked on demand by pdmp3_tpu_torch.host (ctypes loader); builds
``build/torch_host/libpdmp3host_torch.so`` from this package's own
``host/src`` when a source is newer than the library.  -ffp-contract=off
is load-bearing: FMA contraction would break the scalar DSP's bit parity
with the reference decoder.

The drivers are executables over the same sources, each built on its
first request into ``build/torch_host/``:

- ``cli_bin()``: the ``pdmp3`` CLI (``src/main.cc``), which decodes files
  to ``<file>.raw`` as the reference CLI does;
- ``sanitizer_cli(kind)``: the CLI under ASan + UBSan (``address``) or
  another ``-fsanitize`` kind;
- ``selftest_bin(sanitize)``: the threaded-parse selftest
  (``src/selftest.cc``), optionally under a sanitizer (``thread``: the
  TSan race profile);
- ``parsebench_bin(profile, stats)``: the native parse benchmark
  (``src/parsebench.cc``), with ``-pg`` and / or the rdtsc stage
  counters (``-DPDMP3_PARSE_STATS``);
- ``fuzzer_bin()``: the coverage-guided fuzzer (``src/fuzz_main.cc``
  over library objects built with trace-pc edge coverage and ASan +
  UBSan).

Every output is linked to a temporary path and moved into place with
``os.replace``: several processes (test workers) may start the same
build at once, and none of them may run or load a half-written file.
The generated table include ``src/gen_tables.inc`` is part of the
sources; the build raises if it is missing.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

HOST_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HOST_DIR))
SRC_DIR = os.path.join(HOST_DIR, "src")
BUILD_DIR = os.path.join(REPO, "build", "torch_host")
LIB = os.path.join(BUILD_DIR, "libpdmp3host_torch.so")
CLI = os.path.join(BUILD_DIR, "pdmp3")

SRCS = ["tables.cc", "frame.cc", "dsp.cc", "api.cc", "wire_l12_codes.cc",
        "wire_l3_codes.cc"]
CXXFLAGS = ["-std=c++17", "-O3", "-Wall", "-Wextra", "-fPIC", "-pthread",
            "-ffp-contract=off", "-fno-fast-math"]


def _mtime(path: str) -> float:
    return os.path.getmtime(path) if os.path.exists(path) else -1.0


def _lib_sources() -> list[str]:
    """The library's translation units; FileNotFoundError when the
    generated table include is missing."""
    inc = os.path.join(SRC_DIR, "gen_tables.inc")
    if not os.path.exists(inc):
        raise FileNotFoundError(f"{inc} is missing: it is a tracked source "
                                "of the host library")
    return [os.path.join(SRC_DIR, s) for s in SRCS]


def _headers() -> list[str]:
    return [os.path.join(SRC_DIR, "gen_tables.inc"),
            os.path.join(SRC_DIR, "internal.h"),
            os.path.join(HOST_DIR, "include", "pdmp3.h")]


def _debug_flags(sanitize: str) -> list[str]:
    """CXXFLAGS at -O1 with debug info, frame pointers and
    -fsanitize=`sanitize`."""
    return [f for f in CXXFLAGS if f != "-O3"] + [
        "-O1", "-g", f"-fsanitize={sanitize}", "-fno-omit-frame-pointer"]


def _run(cmds: list[list[str]], target: str, verbose: bool) -> None:
    """Run the g++ commands at once; RuntimeError with the first failing
    one's output."""
    for cmd in cmds:
        if verbose:
            print(" ".join(cmd))
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode:
            raise RuntimeError(f"g++ failed for {target}:\n"
                               f"{' '.join(cmd)}\n{err[-4000:]}")


def _build(target: str, srcs: list[str], flags: list[str],
           link: list[str], deps: list[str], cov: list[str] | None = None,
           verbose: bool = False) -> str:
    """`target`, rebuilt when a dep is newer: each of srcs compiled with
    `flags` (+ `cov`, the library's sources only) into an object of a
    private scratch directory, all at once, then linked with `flags` +
    `link` to a temporary path that is moved onto target."""
    built = _mtime(target)
    if built >= 0 and all(_mtime(d) <= built for d in deps):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    scratch = tempfile.mkdtemp(dir=BUILD_DIR)
    lib = set(_lib_sources())
    try:
        objs = [os.path.join(scratch, os.path.basename(s) + ".o")
                for s in srcs]
        _run([["g++", *flags, *(cov or [] if s in lib else []),
               "-c", "-o", o, s] for s, o in zip(srcs, objs)],
             target, verbose)
        _run([["g++", *flags, *link, "-o", tmp, *objs]], target, verbose)
        os.replace(tmp, target)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def _executable(name: str, driver: str, flags: list[str],
                cov: list[str] | None = None) -> str:
    """build/torch_host/`name`: the library sources (compiled with `cov`
    too) and src/`driver` compiled with `flags` into one executable."""
    srcs = _lib_sources() + [os.path.join(SRC_DIR, driver)]
    return _build(os.path.join(BUILD_DIR, name), srcs, flags, [],
                  srcs + _headers(), cov)


def ensure_built(verbose: bool = False) -> str:
    """Path of the host library, compiling it if a source is newer."""
    srcs = _lib_sources()
    return _build(LIB, srcs, CXXFLAGS, ["-shared"], srcs + _headers(),
                  verbose=verbose)


def cli_bin() -> str:
    """The ``pdmp3`` CLI: ``pdmp3 file.mp3 ...`` writes ``file.mp3.raw``
    (S16LE), as the reference CLI does."""
    return _executable("pdmp3", "main.cc", CXXFLAGS)


def sanitizer_cli(kind: str = "address") -> str:
    """The CLI instrumented with -fsanitize=`kind` (``address`` adds
    ``undefined``), for memory-safety checks of the frontend and DSP on
    hostile inputs."""
    san = f"{kind},undefined" if kind == "address" else kind
    return _executable(f"pdmp3_{kind[:4]}", "main.cc", _debug_flags(san))


def selftest_bin(sanitize: str | None = None) -> str:
    """The threaded-frontend selftest driver (``src/selftest.cc``:
    ``n_slots n_threads steps stream...``; exit 0 when the threaded parse
    equals the single-threaded one), optionally under a sanitizer
    (``thread`` for the TSan race profile over
    pdmp3_parse_step_wire16)."""
    tag = f"_{sanitize[:4]}" if sanitize else ""
    return _executable(f"pdmp3_selftest{tag}", "selftest.cc",
                       _debug_flags(sanitize) if sanitize else CXXFLAGS)


def parsebench_bin(profile: bool = False, stats: bool = False) -> str:
    """The native parse-throughput benchmark (``src/parsebench.cc``:
    ``n_slots n_threads seconds stream...``, one JSON line).
    profile=True adds -pg for gprof; stats=True compiles the
    PDMP3_PARSE_STATS rdtsc stage counters (slower: the counters sit in
    the hot loops) and prints the per-stage cycle split in the JSON."""
    flags = (CXXFLAGS + (["-pg", "-g"] if profile else [])
             + (["-DPDMP3_PARSE_STATS"] if stats else []))
    name = ("pdmp3_parsebench" + ("_pg" if profile else "")
            + ("_stats" if stats else ""))
    return _executable(name, "parsebench.cc", flags)


def fuzzer_bin() -> str:
    """The coverage-guided frontend fuzzer (``src/fuzz_main.cc``:
    ``seed_dir iters cur_input rng_seed``): the library's translation
    units instrumented with GCC trace-pc edge coverage and ASan + UBSan,
    linked with the uninstrumented driver that collects the bitmap."""
    return _executable("pdmp3_fuzz", "fuzz_main.cc",
                       _debug_flags("address,undefined"),
                       cov=["-fsanitize-coverage=trace-pc"])


if __name__ == "__main__":
    print(ensure_built(verbose=True))
