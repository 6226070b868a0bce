"""Randomized multi-process serving soak: rounds of
``MultiHostStreamDecoder`` over ``torch.distributed`` (gloo), each rank's
slots held bitwise against the native decoder.

    python -m pdmp3_tpu_torch.tools.multihost_soak --rounds 10
    python -m pdmp3_tpu_torch.tools.multihost_soak --rounds 1 --device cpu

Counterpart of ``tools/multihost_soak.py``.  Each round draws its
process count from {2, 2, 4}, its slots per rank, and a random stream
per slot (3-9 frames, every block type, stereo mode and rate, reservoir
or not), so ranks run out at different steps and keep stepping, idle,
until ``global_active`` reads 0 everywhere.  Ranks are spawned (never
forked after CUDA started), joined over localhost TCP, and placed on
``cuda:{rank % device_count}`` (several ranks share a card when there are
fewer cards than ranks) or, with ``--device cpu``, on the CPU.  Every
round decodes exact (K2 on CUDA, twice per step with an active local
slot), and each slot's PCM must equal ``native_decode_file``'s.

Where the JAX tool drew more: its ``kernel`` axis (``xla`` / ``pallas``)
has no counterpart, the port having one route per device; and its
``dev_per_proc`` axis (a virtual CPU mesh inside each process) becomes a
draw of slots per rank, since a port rank serves one unsharded pool on
one device (``runtime/multihost.py``).  A round that fails or outlives
``--timeout`` kills every rank and ends the run with exit code 1.
Results accumulate in ``--out`` (``build/torch_tools/
multihost_soak.json`` by default) across runs.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import random
import socket
import sys
import tempfile
import time

from . import default_out, write_json

MAX_STEPS = 64


def draw_round(rng: random.Random) -> dict:
    """One round's processes, slots per rank and stream specs."""
    procs = rng.choice([2, 2, 4])
    per_rank = rng.choice([2, 4]) * rng.choice([1, 2])
    specs = [dict(n_frames=rng.randint(3, 9),
                  seed=rng.randint(0, 10 ** 6),
                  blocks=rng.choice(["long", "varied", "short", "mixed"]),
                  mode=rng.choice([0, 1, 1, 3]),
                  mode_extension=rng.choice([0, 1, 2, 3]),
                  sfreq=rng.choice([0, 0, 1, 2]),
                  use_reservoir=rng.random() < 0.4)
             for _ in range(procs * per_rank)]
    return {"procs": procs, "slots_per_rank": per_rank,
            "n_global": procs * per_rank, "streams": specs}


def seed_with_procs(procs: int, start: int = 0) -> int:
    """The first seed from `start` whose round draws `procs` ranks."""
    seed = start
    while draw_round(random.Random(seed))["procs"] != procs:
        seed += 1
    return seed


def rank_main(cfg: dict, rank: int, port: int, out_path: str) -> None:
    """One rank (a spawned process): join the group, serve this rank's
    slots exact until every rank's streams ended, hold each slot against
    the native decoder, write the rank's record to out_path."""
    import torch
    import torch.distributed as dist

    from ..host import native_decode_file
    from ..runtime import MultiHostStreamDecoder
    from ..testing import mp3gen
    from . import launched_since, launches

    if cfg["device"] == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device(cfg["device"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}",
        world_size=cfg["procs"], rank=rank,
        timeout=datetime.timedelta(seconds=cfg["timeout"]))
    try:
        dec = MultiHostStreamDecoder(cfg["n_global"], device=dev,
                                     exact=True)
        n = dec.n
        streams = [mp3gen.make_stream(**spec)
                   for spec in cfg["streams"][rank * n:(rank + 1) * n]]
        for s in range(n):
            if dec.feed(s, streams[s]) != 0:
                raise RuntimeError(f"rank {rank}: feed of slot {s} failed")
        outs = [[] for _ in range(n)]
        before = launches()
        steps = busy = 0
        for _ in range(MAX_STEPS):
            na = dec.parse_step()
            if dec.global_active(na) == 0:
                break
            pcm = dec.decode_step()
            steps += 1
            busy += na > 0
            for s in range(n):
                if dec.active[s]:
                    outs[s].append(pcm[s][:, 0].tobytes()
                                   if dec.nch(s) == 1 else pcm[s].tobytes())
        else:
            raise RuntimeError(f"rank {rank}: streams not done after "
                               f"{MAX_STEPS} steps")
        ran = launched_since(before)
        want = {"fused_granule_exact": 2 * busy, "l3_expand": busy} \
            if dev.type == "cuda" and busy else {}
        if ran != want:
            raise RuntimeError(f"rank {rank}: launched {ran}, want {want}")
        for s in range(n):
            ref = native_decode_file(streams[s])
            got = b"".join(outs[s])
            if got[:len(ref)] != ref or len(got) < len(ref):
                raise RuntimeError(f"rank {rank} slot {s}: PCM differs "
                                   "from the native decoder")
        with open(out_path, "w") as f:
            json.dump({"rank": rank, "device": str(dev), "slots": n,
                       "steps": steps, "steps_with_work": busy,
                       "launches": ran}, f)
    finally:
        dist.destroy_process_group()


def run_round(seed: int, device: str, timeout: float) -> dict:
    """One round drawn from `seed`; raises when a rank fails or the round
    outlives `timeout` (every rank still running is killed first)."""
    import multiprocessing

    from ..host import build as host_build

    host_build.ensure_built()      # built once, before the ranks start
    cfg = {**draw_round(random.Random(seed)), "device": device,
           "timeout": timeout}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json")
                for r in range(cfg["procs"])]
        ps = [ctx.Process(target=rank_main, args=(cfg, r, port, outs[r]))
              for r in range(cfg["procs"])]
        for p in ps:
            p.start()
        try:
            while (any(p.is_alive() for p in ps)
                   and time.perf_counter() - t0 < timeout
                   and all(p.exitcode in (None, 0) for p in ps)):
                time.sleep(0.05)
        finally:
            alive = [p for p in ps if p.is_alive()]
            for p in alive:
                p.kill()
            for p in ps:
                p.join()
        codes = [p.exitcode for p in ps]
        if alive or any(codes):
            raise RuntimeError(f"round {seed}: rank exit codes {codes} "
                               f"after {time.perf_counter() - t0:.1f} s")
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    return {"seed": seed, "procs": cfg["procs"],
            "slots_per_rank": cfg["slots_per_rank"],
            "n_global": cfg["n_global"], "device": device, "ok": True,
            "seconds": time.perf_counter() - t0, "ranks": ranks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--out", default=default_out("multihost_soak.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from . import resolve_device
        resolve_device("cuda")       # raise here, not in every rank
    prior = {"rounds": [], "total_ok": 0, "total": 0}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
    failed = None
    for i in range(args.rounds):
        seed = args.seed_base + i
        try:
            r = run_round(seed, args.device, args.timeout)
        except RuntimeError as e:
            failed = str(e)
            r = {"seed": seed, "device": args.device, "ok": False,
                 "error": failed}
        prior["rounds"].append(r)
        prior["total"] += 1
        prior["total_ok"] += int(r["ok"])
        print(f"[{i + 1}/{args.rounds}] {json.dumps(r)}", flush=True)
        if failed:
            break
    write_json(args.out, prior)
    print(json.dumps({"total": prior["total"],
                      "total_ok": prior["total_ok"]}))
    if failed:
        sys.exit(1)
    return prior


if __name__ == "__main__":
    main()
