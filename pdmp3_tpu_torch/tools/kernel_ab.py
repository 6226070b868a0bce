#!/usr/bin/env python3
"""Compare this checkout's CUDA kernels with another checkout's on one GPU.

    python3 pdmp3_tpu_torch/tools/kernel_ab.py OTHER_CHECKOUT

Builds both checkouts' kernel libraries, then:

1. times K1, K2 and K4 (both modes) of each checkout at B = 8192 on the
   same synthetic operands (CUDA events, median of 25 launches), each
   checkout in its own process, in the order given by ``--order``
   (default: other, this, this, other), one JSON line per process;
2. compares the SASS of every kernel the two libraries share
   (``cuobjdump -sass``, addresses and encodings dropped) and prints,
   per kernel, whether the instruction streams are identical.

Both measurements belong in one call: device times spread between calls
by more than the differences they are meant to show.  The card's name
and power limit are printed first.  An older checkout whose package
imports another package of this repository finds it through PYTHONPATH,
which is set to this checkout's root for its process.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B = 8192
LAUNCHES = 25


def time_kernels(tree: str) -> dict:
    """Median device ms of K1, K2, K4 exact and K4 fast of `tree`'s
    package on synthetic operands."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from pdmp3_tpu_torch.models.decoder import init_state
    from pdmp3_tpu_torch.ops import _build
    from pdmp3_tpu_torch.ops import back_half as BH
    from pdmp3_tpu_torch.ops import dsp as D
    from pdmp3_tpu_torch.ops import fused_step as FS

    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}")
    _build.ensure_built()
    dev = torch.device("cuda")
    g = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ix = g.integers(-20, 21, (B, 2, 576)).astype(np.int16)
    ix[:, :, 400:] = 0
    meta = np.zeros((B, 32), np.int32)
    lay = g.integers(0, 9, (B, 2))
    kind = lay % 3                       # long, short, mixed
    meta[:, 0:2] = lay
    meta[:, 2:4] = np.where(kind > 0, 2, 0)
    meta[:, 4:6] = kind > 0
    meta[:, 6:8] = kind == 2
    meta[:, 8:10] = 180                  # global gain
    meta[:, 14:16] = 400                 # count1
    meta[:, 22] = g.integers(0, 2, B)    # MS
    meta[:, 23] = g.integers(0, 2, B)    # intensity
    meta[:, 24] = 2
    ops = (t(ix), t(g.integers(0, 8, (B, 2, 22)).astype(np.int16)),
           t(g.integers(0, 8, (B, 2, 39)).astype(np.int16)), t(meta),
           torch.ones(B, dtype=torch.int32, device=dev))

    def median_ms(fn) -> float:
        times = []
        for _ in range(LAUNCHES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    res = {}
    for exact in (False, True):
        st = init_state(B, dev)
        res["k2" if exact else "k1"] = median_ms(
            lambda: FS.fused_granule_step(*ops, 0, st, exact=exact))
    f = D.fields(ops[3])
    bt = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    xa = t(g.standard_normal((B, 2, 32, 18)).astype(np.float32))
    for exact in (True, False):
        st = init_state(B, dev)
        res["k4_exact" if exact else "k4_fast"] = median_ms(
            lambda: BH.back_half_step(xa, st, bt, ops[4], exact))
    return res


def build(tree: str) -> str:
    """Path of `tree`'s kernel library, built in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pdmp3_tpu_torch.ops import _build; "
            "print(_build.ensure_built())")
    out = subprocess.run([sys.executable, "-c", code, tree], check=True,
                         capture_output=True, text=True, env=_env())
    return out.stdout.strip().splitlines()[-1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=HERE)


def sass(lib: str) -> dict:
    """Kernel name (template arguments kept, namespace hash dropped) ->
    its SASS instructions without addresses and encodings."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : \S*?\d+([a-z_]+_kernel)(I\w+?EE)", ln)
        if m:
            name = m.group(1) + m.group(2)
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            out[name].append(re.sub(r"/\*[0-9a-f]+\*/", "",
                                    ln.split(";")[0]).strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--order", default="other,this,this,other",
                    help="comma-separated run order of 'this' and 'other'")
    ap.add_argument("--time", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_kernels(args.time)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    trees = {"this": HERE, "other": os.path.abspath(args.other)}
    libs = {k: build(v) for k, v in trees.items()}
    for k in args.order.split(","):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              trees[k], "--time", trees[k]], check=True,
                             capture_output=True, text=True, env=_env())
        print(json.dumps({"tree": k,
                          **json.loads(out.stdout.splitlines()[-1])}))
    this, other = sass(libs["this"]), sass(libs["other"])
    for name in sorted(set(this) & set(other)):
        print(json.dumps({"kernel": name, "instructions": len(this[name]),
                          "sass_identical": this[name] == other[name]}))
    for name in sorted(set(this) ^ set(other)):
        print(json.dumps({"kernel": name, "only_in":
                          "this" if name in this else "other"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
