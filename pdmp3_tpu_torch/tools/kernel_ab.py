#!/usr/bin/env python3
"""Compare this checkout's CUDA kernels with another checkout's on one GPU.

    python3 pdmp3_tpu_torch/tools/kernel_ab.py OTHER_CHECKOUT
    python3 pdmp3_tpu_torch/tools/kernel_ab.py --ablate

Builds both checkouts' kernel libraries, then:

1. times K1, K2, K3 (fast and exact, both LSF families), K4 (both
   modes, at B = 8192 and at one slot), K5 at ng = 2 (the MPEG-1
   instance over two granules, parities (0, 1)), K6 (one 2^24-input
   chunk, the three rounding points: one launch, or one launch per point
   in a tree without the three-in-one kernel), K7's eight instances (B =
   8192 slots of one synthetic Layer I / II frame, every slot active,
   mono in one slot of seven; ``k7_l{layer}_{fast,exact}_{s16,float}``)
   and K8 at the resampling pool's shape (B = 8192 streams, a 1,152-sample
   int16 block, C = 2, 44.1 -> 48 kHz, int16 out) of each checkout on the
   same synthetic operands, each kernel three ways
   (``pdmp3_tpu_torch/timing.py``, this checkout's copy for both
   trees): ``ms``, its device time per launch
   from CUDA events around replays of a CUDA graph of 25 calls;
   ``burst_ms``, CUDA events around a burst of 25
   back-to-back calls over the calls, median of 5 bursts; ``per_call_ms``,
   events around one call, launcher included, median of 25; and K1
   against K5 at ng = 1 (the same granule with the state in K5's state
   set), interleaved call by call; each checkout in its own process, in
   the order given by ``--order`` (default: other, this, this, other),
   one JSON line per process;
2. compares the SASS of every kernel the two libraries share
   (``cuobjdump -sass``, addresses and encodings dropped) and prints,
   per kernel, whether the instruction streams are identical, with the
   static counts of the memory, barrier and f32 instructions
   (``SASS_OPS``) of every kernel of both libraries;
3. prints each checkout's registers, spills and shared memory per
   kernel instance from its build log (``-Xptxas -v``).

Both measurements belong in one call: device times spread between calls
by more than the differences they are meant to show.  The card's name
and power limit are printed first.  An older checkout whose package
imports another package of this repository finds it through PYTHONPATH,
which is set to this checkout's root for its process.

``--ablate`` instead times this checkout against copies of its package
(``build/kernel_ab/<stages>/``) whose K1/K2 body skips one stage of the
slot loop (``STAGES``: its block emptied), and one that skips all of
them, in the order this, each copy, this: what each stage costs per
launch, and what the staging, barriers and copies cost alone.  The
copies compute wrong PCM; only their times mean anything.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B = 8192
LAUNCHES = 25
# SASS opcodes counted per kernel: opcode prefix -> label (LDS.64 and
# LDS.128 are also counted within LDS)
SASS_OPS = ("LDG", "LDS", "LDS.64", "LDS.128", "STS", "STG", "LDGSTS",
            "UBLKCP", "SYNCS", "BAR", "FMUL", "FADD", "DMUL", "DADD", "LDL",
            "STL")
# the comment that opens each stage of the slot loop in
# csrc/granule_persist.cuh; --ablate empties the braced block after it
STAGES = {"front": "// ---- requantize + stereo",
          "antialias": "// ---- antialias",
          "imdct": "// ---- IMDCT",
          "matrix": "// ---- polyphase matrixing",
          "fir": "// ---- 16-tap D-window FIR"}


def timing():
    """This checkout's pdmp3_tpu_torch/timing.py, loaded by path, so that
    both trees are timed by the same code."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_timing", os.path.join(HERE, "pdmp3_tpu_torch",
                                         "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_kernels(tree: str) -> dict:
    """Device times (timing.kernel_times) of K1, K2, K3
    (k3_f{family}_{fast,exact}), K4 exact and fast at B and at one slot,
    K5 at ng = 2, K6 per chunk, K7's eight instances and K8 of `tree`'s
    package on synthetic operands, and the interleaved K1 / K5-at-ng=1
    pair."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from pdmp3_tpu_torch.models.decoder import init_state
    from pdmp3_tpu_torch.ops import _build
    from pdmp3_tpu_torch.ops import back_half as BH
    from pdmp3_tpu_torch.ops import dsp as D
    from pdmp3_tpu_torch.ops import frame_step as FR
    from pdmp3_tpu_torch.ops import fused_step as FS
    from pdmp3_tpu_torch.ops import rounding as R

    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}")
    _build.ensure_built()
    T = timing()
    dev = torch.device("cuda")
    ops = synthetic_operands(dev)

    def times(fn):
        return T.kernel_times(fn, LAUNCHES)

    res = {}
    for exact in (False, True):
        st = init_state(B, dev)
        res["k2" if exact else "k1"] = times(
            lambda: FS.fused_granule_step(*ops, 0, st, exact=exact))
    for family in (1, 2):
        lops, ip = synthetic_lsf_operands(dev, family)
        for exact in (False, True):
            st = init_state(B, dev)
            res[f"k3_f{family}_{'exact' if exact else 'fast'}"] = times(
                lambda: FS.fused_granule_step(*lops, 0, st, exact=exact,
                                              family=family, is_pos=ip))
    f2 = [torch.stack([o, o]) for o in ops]
    st = init_state(B, dev)
    res["k5_ng2"] = times(lambda: FR.frame_step(*f2, (0, 1), st))
    res.update(k1_vs_k5_ng1(ops, init_state(B, dev), init_state(B, dev),
                            T.per_call_ms))
    f = D.fields(ops[3])
    bt = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    xa = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 2, 32, 18)).astype(np.float32)).to(dev)
    for exact in (True, False):
        mode = "exact" if exact else "fast"
        st = init_state(B, dev)
        res[f"k4_{mode}"] = times(
            lambda: BH.back_half_step(xa, st, bt, ops[4], exact))
        st1 = init_state(1, dev)
        one = (xa[:1], st1, bt[:1].contiguous(), ops[4][:1])
        res[f"k4_{mode}_one_slot"] = times(
            lambda: BH.back_half_step(*one, exact))
    n = 1 << 24
    if hasattr(R, "rounding_sweep_all"):
        res["k6"] = times(lambda: R.rounding_sweep_all(n, n, dev))
        res["k6_ms_per_chunk"] = res["k6"]["ms"]
    else:  # an older tree: one launch per construction
        res["k6_single"] = {
            c: times(lambda: R.rounding_sweep_step(c, n, n, dev))
            for c in R.CONSTRUCTIONS}
        res["k6_ms_per_chunk"] = sum(r["ms"] for r in
                                     res["k6_single"].values())
    res.update(time_k7_k8(dev, times))
    return res


def time_k7_k8(dev, times) -> dict:
    """times() of K7's eight instances (k7_l{layer}_{mode}_{pcm}) on
    l12_operands and of K8 on resample_operands, when the tree has them
    (ops/l12_synth.py, ops/resample.py resample_block)."""
    import importlib

    out = {}
    try:
        K7 = importlib.import_module("pdmp3_tpu_torch.ops.l12_synth")
        from pdmp3_tpu_torch.models.l12 import L12State
    except ImportError:
        K7 = None
    for layer, S in ((1, 12), (2, 36)) if K7 else ():
        sb, nch, act, v = l12_operands(dev, S)
        for exact in (False, True):
            for float_pcm in (False, True):
                st = L12State(v_blocks=v.clone())
                name = (f"k7_l{layer}_{'exact' if exact else 'fast'}_"
                        f"{'float' if float_pcm else 's16'}")
                out[name] = times(lambda: K7.l12_synth_step(
                    sb, nch, act, st, exact, float_pcm))
    RS = importlib.import_module("pdmp3_tpu_torch.ops.resample")
    if hasattr(RS, "resample_block"):
        args = resample_operands(dev, RS)
        out["k8"] = times(lambda: RS.resample_block(*args))
    return out


def l12_operands(dev, S: int, B: int = B) -> tuple:
    """K7's operands for B slots from a seeded generator: sb f32 [B, 2,
    S, 32] of subband samples in [-1, 1) that fade with the subband, nch
    int16 (every seventh slot mono), active int16 (all 1), a random FIFO
    f32 [B, 2, 15, 64]."""
    import numpy as np
    import torch

    g = np.random.default_rng(7 + S)
    sb = (g.uniform(-1, 1, (B, 2, S, 32))
          / (1 + np.arange(32))).astype(np.float32)
    nch = np.full(B, 2, np.int16)
    nch[::7] = 1
    v = (g.standard_normal((B, 2, 15, 64)) * 0.1).astype(np.float32)
    return (torch.from_numpy(sb).to(dev), torch.from_numpy(nch).to(dev),
            torch.ones(B, dtype=torch.int16, device=dev),
            torch.from_numpy(v).to(dev))


def resample_operands(dev, RS, B: int = B) -> tuple:
    """resample_block's arguments at the resampling pool's shape: B
    streams of a seeded 1,152-sample int16 block, C = 2, 44.1 -> 48 kHz
    from phase 0, a seeded carry, int16 out."""
    import numpy as np
    import torch

    g = np.random.default_rng(8)
    up, down, taps = 160, 147, 24
    pcm = np.clip(g.standard_normal((B, 1152, 2)) * 9000, -32768,
                  32767).astype(np.int16)
    carry = np.round(g.standard_normal((B, taps - 1, 2)) * 9000)
    H = torch.from_numpy(RS.polyphase_filter(up, down, taps)).to(dev)
    n_out = (1152 * up + down - 1) // down
    return (torch.from_numpy(carry.astype(np.float32)).to(dev),
            torch.from_numpy(pcm).to(dev), 0, up, down, H, n_out,
            torch.int16)


def synthetic_operands(dev, B: int = B) -> tuple:
    """K1's operands (ix, scf_l, scf_s, meta, active) for B slots from a
    seeded generator: random lines below 400, layouts of every kind
    (long, short, mixed), MS and intensity on random slots, every slot
    active."""
    import numpy as np
    import torch

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
    return (t(ix), t(g.integers(0, 8, (B, 2, 22)).astype(np.int16)),
           t(g.integers(0, 8, (B, 2, 39)).astype(np.int16)), t(meta),
           torch.ones(B, dtype=torch.int32, device=dev))


def synthetic_lsf_operands(dev, family: int, B: int = B) -> tuple:
    """K3's operands for one LSF family: synthetic_operands' with meta's
    family and iscale words set (iscale random) and a seeded is_pos
    sidecar [B, 64] (positions 0..7, one in ten illegal); (ops,
    is_pos)."""
    import numpy as np
    import torch

    ix, scf_l, scf_s, meta, act = synthetic_operands(dev, B)
    g = np.random.default_rng(family)
    meta = meta.clone()
    meta[:, 26] = family
    meta[:, 27] = torch.from_numpy(g.integers(0, 2, B).astype(np.int32)).to(
        dev)
    ip = g.integers(0, 8, (B, 64)).astype(np.int16)
    ip[g.random((B, 64)) < 0.1] = 63
    return (ix, scf_l, scf_s, meta, act), torch.from_numpy(ip).to(dev)


def k1_vs_k5_ng1(ops, s1, s5, per_call_ms) -> dict:
    """K1 and K5 at ng = 1 (frame_step over the same granule, parity 0)
    on the same operands, alternating call by call (per_call_ms of one
    call each): medians and their ratio."""
    from pdmp3_tpu_torch.ops import frame_step as FR
    from pdmp3_tpu_torch.ops import fused_step as FS

    f_ops = [o[None] for o in ops]
    k1, k5 = [], []
    for _ in range(LAUNCHES):
        k1.append(per_call_ms(lambda: FS.fused_granule_step(*ops, 0, s1), 1))
        k5.append(per_call_ms(lambda: FR.frame_step(*f_ops, (0,), s5), 1))
    m1, m5 = sorted(k1)[LAUNCHES // 2], sorted(k5)[LAUNCHES // 2]
    return {"k1_interleaved": m1, "k5_ng1_interleaved": m5,
            "k5_ng1_over_k1": m5 / m1}


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


def time_tree(tree: str) -> dict:
    """time_kernels(tree) in a process of its own."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--time", tree], check=True,
                         stdout=subprocess.PIPE, text=True, env=_env())
    return json.loads(out.stdout.splitlines()[-1])


def skip_stages(src: str, stages: list[str]) -> str:
    """granule_persist.cuh's text with the block after each of `stages`'
    opening comments emptied."""
    for st in stages:
        lo = src.index("{", src.index(STAGES[st]))
        depth, hi = 0, lo
        while True:
            depth += {"{": 1, "}": -1}.get(src[hi], 0)
            if depth == 0:
                break
            hi += 1
        src = src[:lo] + "{}" + src[hi + 1:]
    return src


def ablated_tree(stages: list[str]) -> str:
    """Root of a copy of this checkout's package whose K1/K2 body skips
    `stages`."""
    root = os.path.join(HERE, "build", "kernel_ab", "+".join(stages))
    pkg = os.path.join(root, "pdmp3_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "pdmp3_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, "csrc", "granule_persist.cuh")
    with open(path) as f:
        src = skip_stages(f.read(), stages)
    with open(path, "w") as f:
        f.write(src)
    return root


def sass(lib: str) -> dict:
    """sass_functions of `lib`'s cuobjdump -sass listing."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    return sass_functions(subprocess.run(
        [cuobjdump, "-sass", lib], check=True, capture_output=True,
        text=True).stdout)


def sass_functions(text: str) -> dict:
    """Kernel name (template arguments kept, namespace hash and the
    parameter list of a kernel without template arguments dropped) -> its
    SASS instructions without addresses and encodings; functions that are
    not a kernel of the port are left out."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = re.match(r"\s*Function : \S*?\d+([a-z_]+_kernel)(I\w+?EE)?",
                         ln)
            name = m.group(1) + (m.group(2) or "") if m else None
            if name:
                out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            out[name].append(re.sub(r"/\*[0-9a-f]+\*/", "",
                                    ln.split(";")[0]).strip())
    return out


def sass_counts(instructions: list[str]) -> dict:
    """Static counts of the SASS_OPS opcodes (predicates dropped): an
    entry with a width (LDS.128) counts the opcodes of that base with
    that width among their modifiers."""
    ops = [(ln.split()[1] if ln.startswith("@") else ln.split()[0])
           .split(".") for ln in instructions if ln.strip()]
    out = {}
    for k in SASS_OPS:
        base, _, width = k.partition(".")
        out[k] = sum(op[0] == base and (not width or width in op[1:])
                     for op in ops)
    return out


def ptxas(tree: str) -> list[str]:
    """Registers, spills and shared memory per kernel instance from
    `tree`'s build log."""
    sys.path.insert(0, HERE)
    from pdmp3_tpu_torch.ops._build import ptxas_summary
    with open(os.path.join(tree, "build", "torch_kernels",
                           "build.log")) as f:
        return ptxas_summary(f.read())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--order", default="other,this,this,other",
                    help="comma-separated run order of 'this' and 'other'")
    ap.add_argument("--ablate", action="store_true",
                    help="time K1/K2 with each stage skipped instead")
    ap.add_argument("--time", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_kernels(args.time)))
        return 0
    if not args.ablate and args.other is None:
        ap.error("give OTHER_CHECKOUT or --ablate")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    if args.ablate:
        skips = [[st] for st in STAGES] + [list(STAGES)]
        runs = [("this", HERE)] + [
            ("skip " + "+".join(s), ablated_tree(s)) for s in skips] + [
            ("this", HERE)]
        for label, tree in runs:
            print(json.dumps({"tree": label, **time_tree(tree)}))
        return 0
    trees = {"this": HERE, "other": os.path.abspath(args.other)}
    libs = {k: build(v) for k, v in trees.items()}
    for k in args.order.split(","):
        print(json.dumps({"tree": k, **time_tree(trees[k])}))
    this, other = sass(libs["this"]), sass(libs["other"])
    for name in sorted(set(this) & set(other)):
        print(json.dumps({"kernel": name, "instructions": len(this[name]),
                          "sass_identical": this[name] == other[name]}))
    for name in sorted(set(this) ^ set(other)):
        print(json.dumps({"kernel": name, "only_in":
                          "this" if name in this else "other"}))
    for k, lib in (("this", this), ("other", other)):
        for name in sorted(lib):
            print(json.dumps({"tree": k, "kernel": name,
                              "instructions": len(lib[name]),
                              "sass_counts": sass_counts(lib[name])}))
        print(json.dumps({"tree": k, "ptxas": ptxas(trees[k])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
