"""The port's multi-process serving form (pdmp3_tpu_torch/runtime/
multihost.py), after tests/test_multihost.py: two OS processes joined by
torch.distributed over gloo on the CPU, each with its own native
frontend and its half of 8 global slots.  Streams have uneven lengths,
so rank 0 runs out first and keeps stepping, idle, until
``global_active`` reads 0 on both.  Each rank's PCM is checked against
the native scalar decoder, bitwise (exact mode).

The workers import the port only; the test builds the port's host
library before it starts them, so no worker builds it.  Each run has its
own timeout and kills both workers when either fails.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from pdmp3_tpu_torch import MultiHostStreamDecoder
from pdmp3_tpu_torch.host import build as host_build

TIMEOUT_S = 180

_WORKER = textwrap.dedent("""
    import os, sys
    rank, port, outdir, family = (int(sys.argv[1]), sys.argv[2],
                                  sys.argv[3], int(sys.argv[4]))
    import numpy as np
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    from pdmp3_tpu_torch import MultiHostStreamDecoder
    from pdmp3_tpu_torch.host import PROFILE_LSF, native_decode_file
    from pdmp3_tpu_torch.testing import mp3gen

    N_GLOBAL, N_LOCAL = 8, 4
    if family:
        streams = [mp3gen.make_stream(
            n_frames=4 + g, seed=900 + g, family=family, sfreq=g % 3,
            bitrate_index=11, mode=[0, 1, 1, 3][g % 4],
            mode_extension=3 if g % 2 else 0, stereo_extent_ch1=0.4)
            for g in range(N_GLOBAL)]
    else:
        streams = [mp3gen.make_stream(
            n_frames=3 + g, seed=900 + g,
            blocks=["long", "varied", "short", "mixed"][g % 4],
            mode=[0, 1, 1, 3][g % 4], mode_extension=2 if g % 2 else 0)
            for g in range(N_GLOBAL)]
    dec = MultiHostStreamDecoder(N_GLOBAL, device="cpu", exact=True,
                                 family=family)
    assert (dec.n, dec.pid, dec.procs, dec.n_global) == (N_LOCAL, rank, 2,
                                                         N_GLOBAL)
    for s in range(N_LOCAL):
        assert dec.feed(s, streams[rank * N_LOCAL + s]) == 0
    outs = [[] for _ in range(N_LOCAL)]
    idle_steps = 0
    for _ in range(64):
        na = dec.parse_step()
        if dec.global_active(na) == 0:
            break
        pcm = dec.decode_step()
        assert pcm.shape == (N_LOCAL, 576 if family else 1152, 2)
        if na == 0:
            assert not pcm.any()
            idle_steps += 1
        for s in range(N_LOCAL):
            if dec.active[s]:
                outs[s].append(pcm[s][:, 0].tobytes() if dec.nch(s) == 1
                               else pcm[s].tobytes())
    else:
        raise SystemExit("the ranks did not drain")
    # rank 0's streams are the shorter: it stepped idle while rank 1 ran
    assert (idle_steps > 0) == (rank == 0), idle_steps
    for s in range(N_LOCAL):
        want = native_decode_file(streams[rank * N_LOCAL + s],
                                  profile=PROFILE_LSF if family else 0)
        got = b"".join(outs[s])
        assert len(want) > 0 and got[:len(want)] == want, f"slot {s}"
    dist.destroy_process_group()
    with open(os.path.join(outdir, f"ok{rank}"), "w") as f:
        f.write("MH_OK")
""")


def _run_two_ranks(tmp_path, family: int) -> None:
    host_build.ensure_built()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(rank), str(port), str(tmp_path),
         str(family)], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
        assert (tmp_path / f"ok{rank}").read_text() == "MH_OK"


@pytest.mark.parametrize("family", [0, 1], ids=["mpeg1", "mpeg2"])
def test_two_process_decode_is_bitwise_native(tmp_path, family):
    """MPEG-1 and MPEG-2 exact pools over two gloo ranks: every slot of
    both ranks bitwise equal to the native decoder, the idle rank's PCM
    zeros of the right shape while it waits for the other."""
    _run_two_ranks(tmp_path, family)


def test_refuses_without_a_process_group():
    """No fallback to a one-process pool: without an initialised
    torch.distributed group the decoder raises."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        MultiHostStreamDecoder(8, device="cpu")
