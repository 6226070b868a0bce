"""The readings that the limits of ``correct`` were set from, on the card:

    python3 -m benchmark.control --workload <cell> --seconds <s> \\
        --seeds <n> ...

For each seed, the numbers compared of a sound run of the cell (the
program as its configuration states) and of its control in the
program's place (``run.run_cell(control=True)``): the program's own
lower-precision path, in a run of its own, or the reference computed
with TF32 operands, on the frames of the sound run.  One JSON line
each.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from . import spec
    from .run import run_cell
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    tf32 = cell.config["control"]["kind"] == "reference_tf32"
    for seed in args.seeds:
        # the TF32 reference replaces the program's frames after one
        # run, which also gives the program's own numbers
        for control in ((True,) if tf32 else (False, True)):
            out = run_cell(cell, seed, args.seconds, False, dev,
                           time.perf_counter(), control=control)
            rows = [("control" if control else "sound", out["checks"],
                     out["correct"])]
            if "sound_checks" in out:
                sound = out["sound_checks"]
                rows.append(("sound", sound, all(
                    c["value"] <= c["limit"] for c in sound.values())))
            for kind, checks, correct in rows:
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "kind": kind, "correct": correct,
                                  "checks": checks,
                                  "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
