"""The port's tools (pdmp3_tpu_torch/tools/) on the CPU at tiny sizes.

- ``serving_diff.make_streams`` and the soak's samplers give the JAX
  tools' bytes and configs for the same seeds (the JAX soak configures
  JAX when imported, so its side runs in a subprocess);
- each tool's ``main`` runs with ``--device cpu`` and writes its JSON:
  the serving diff over 4 streams (exact 0 LSB, fast within 1 LSB of
  native), the scale simulation at 64 slots over 4 CPU shards (slots
  spot-checked bitwise), the wire profile at B = 16, one two-rank
  multi-process round, an 8-stream soak, the parse sweep at one thread,
  one resample pair, both traces over 2 steps;
- ``scale_sim.tiled_batch`` equals ``frame_to_batches`` over the tiled
  frame list;
- a tool asked for the card raises where there is none.

Tolerance: none beyond each tool's own contract.
"""
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pdmp3_tpu_torch.models import decoder as M
from pdmp3_tpu_torch.tools import (drain_trace, kernel_trace, multihost_soak,
                                   parse_scaling, resample_sweep, scale_sim,
                                   serving_diff, soak, wire_profile)

REPO = Path(__file__).resolve().parents[1]
SAMPLER_SEEDS = 40


@pytest.mark.parametrize("seed_base,workers", [(300000, 1), (7, 1),
                                               (300000, 2)])
def test_make_streams_equal_the_jax_tool(seed_base, workers):
    from tools import tpu_serving_diff

    want = tpu_serving_diff.make_streams(6, seed_base)
    assert serving_diff.make_streams(6, seed_base, workers) == want


_JAX_SAMPLERS = r"""
import hashlib, json, random, sys
sys.path.insert(0, sys.argv[1])
import tools.soak as S
from pdmp3_tpu.testing import mp3gen
n = int(sys.argv[2])
out = {}
for name, off, fn in (("mpeg1", 0, S.random_config),
                      ("lsf", S.LSF_SEED_OFF, S.random_lsf_config),
                      ("real", S.REAL_SEED_OFF, S.random_real_config),
                      ("real_lsf", S.REAL_LSF_SEED_OFF,
                       S.random_real_lsf_config)):
    out[name] = [fn(random.Random(S.CFG_BASE + off + i)) for i in range(n)]
streams = []
for i in range(4):
    cfg = S.random_config(random.Random(S.CFG_BASE + i))
    streams.append(hashlib.sha256(mp3gen.make_stream(
        seed=S.STREAM_BASE + i, **cfg)).hexdigest())
out["streams"] = streams
out["bases"] = [S.CFG_BASE, S.STREAM_BASE, S.LSF_SEED_OFF,
                S.REAL_SEED_OFF, S.REAL_LSF_SEED_OFF, S.MATERIALS]
print(json.dumps(out))
"""


def test_soak_samplers_equal_the_jax_tool():
    import hashlib

    from pdmp3_tpu_torch.testing import mp3gen

    res = subprocess.run([sys.executable, "-c", _JAX_SAMPLERS, str(REPO),
                          str(SAMPLER_SEEDS)], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {}
    for name, off, fn in (("mpeg1", 0, soak.random_config),
                          ("lsf", soak.LSF_SEED_OFF, soak.random_lsf_config),
                          ("real", soak.REAL_SEED_OFF,
                           soak.random_real_config),
                          ("real_lsf", soak.REAL_LSF_SEED_OFF,
                           soak.random_real_lsf_config)):
        got[name] = [fn(random.Random(soak.CFG_BASE + off + i))
                     for i in range(SAMPLER_SEEDS)]
    got["streams"] = [hashlib.sha256(mp3gen.make_stream(
        seed=soak.STREAM_BASE + i,
        **soak.random_config(random.Random(soak.CFG_BASE + i)))).hexdigest()
        for i in range(4)]
    got["bases"] = [soak.CFG_BASE, soak.STREAM_BASE, soak.LSF_SEED_OFF,
                    soak.REAL_SEED_OFF, soak.REAL_LSF_SEED_OFF,
                    soak.MATERIALS]
    assert json.loads(json.dumps(got)) == want


def _out(tmp_path, name):
    return ["--device", "cpu", "--out", str(tmp_path / name)]


def test_serving_diff_main(tmp_path):
    res = serving_diff.main(["--streams", "4", *_out(tmp_path, "sd.json")])
    assert json.loads((tmp_path / "sd.json").read_text()) == res
    assert res["exact"]["native"]["worst_lsb"] == 0
    assert res["exact"]["native"]["streams_bitexact"] == 4
    assert res["fast"]["native"]["worst_lsb"] <= 1
    assert res["fast"]["steps"] > 0 and res["fast"]["launches"] == {}
    assert res["reference"] == "built" or "reference" not in res["fast"]


def test_scale_sim_main_and_tiling(tmp_path):
    res = scale_sim.main(["--slots", "64", "--shards", "4", "--steps", "2",
                          *_out(tmp_path, "ss.json")])
    assert res["shard_rows"] == [16] * 4 and "bitwise" in res["checked"]
    assert res["state_bytes_per_slot"] == 4 * (2 * 32 * 18 + 2 * 15 * 64
                                               + 3)
    fds = scale_sim.archetype_frames()
    small = M.frame_to_batches(fds, "cpu")[0]
    tiled = scale_sim.tiled_batch(small, 24)
    want = M.frame_to_batches([fds[i % 4] for i in range(24)], "cpu")[0]
    for name in ("ix", "scf_l", "scf_s", "meta", "active"):
        assert torch.equal(getattr(tiled, name), getattr(want, name)), name
    assert (tiled.gr1, tiled.family, tiled.is_pos) == (want.gr1,
                                                       want.family, None)


@pytest.mark.parametrize("name,shard,row", [("pcm", 3, 7),
                                            ("v_blocks", 2, 0),
                                            ("prev_lines", 1, 15)])
def test_scale_sim_check_names_the_differing_slot(name, shard, row):
    """check_tiled looks at every row of every shard: one flipped value
    in any of them fails the run, naming its global slot."""
    from pdmp3_tpu_torch.parallel import (decode_granules_sharded,
                                          make_mesh, place_batch,
                                          place_state)
    from pdmp3_tpu_torch.ops.fused_step import fused_granule_step_ref

    small = M.frame_to_batches(scale_sim.archetype_frames(), "cpu")[0]
    mesh = make_mesh(["cpu"] * 4)
    pcm, state, _ = decode_granules_sharded(
        place_batch(scale_sim.tiled_batch(small, 64), mesh),
        place_state(M.init_state(64, "cpu"), mesh), mesh)
    want, st = fused_granule_step_ref(small.ix, small.scf_l, small.scf_s,
                                      small.meta, small.active, small.gr1,
                                      M.init_state(4, "cpu"))
    scale_sim.check_tiled(pcm, state, want, st, 16)
    t = pcm[shard] if name == "pcm" else getattr(state[shard], name)
    t[row].view(-1)[-1] += 1
    with pytest.raises(RuntimeError, match=f"slot {shard * 16 + row}: "
                                           f"{name} differs"):
        scale_sim.check_tiled(pcm, state, want, st, 16)


def test_wire_profile_main(tmp_path):
    res = wire_profile.main(["--batch", "16", "--distinct", "8",
                             "--frames", "12", "--steps", "2",
                             "--e2e-seconds", "0.1", "--trials", "1",
                             "--trial-seconds", "0.1",
                             *_out(tmp_path, "wp.json")])
    dense, sparse = res["rows"]
    assert (dense["wire"], sparse["wire"]) == ("dense", "sparse")
    # the "dense" row is StreamDecoder's, whose MPEG-1 wire is the coded
    # one: both wires upload fewer bytes than the dense layout
    dense_step = 2 * M.soa_layout(16)["total"]
    assert sparse["wire_bytes_per_step"] < dense_step
    assert dense["wire_bytes_per_step"] < dense_step
    assert sparse["sparse_buckets"] == sorted(sparse["sparse_buckets"])
    assert set(res["ab"]["medians"]) == {"dense", "sparse"}
    assert res["decode_steps"] >= 2 * (1 + 2 + 1) + 2 * (1 + 1)


def test_multihost_soak_one_round(tmp_path):
    seed = multihost_soak.seed_with_procs(2)
    res = multihost_soak.main(["--rounds", "1", "--seed-base", str(seed),
                               "--timeout", "180",
                               *_out(tmp_path, "mh.json")])
    assert res["total_ok"] == res["total"] == 1
    r = res["rounds"][0]
    assert r["procs"] == 2 and len(r["ranks"]) == 2
    assert all(k["steps"] > 0 for k in r["ranks"])


def test_soak_main(tmp_path):
    res = soak.main(["--count", "8", "--torch-every", "4",
                     *_out(tmp_path, "soak.json")])
    assert res["failures"] == [] and res["torch_streams"] == 2
    assert res["tally"]["ok"] + res["tally"]["oob_prefix_ok"] == 8
    again = soak.main(["--start", "8", "--count", "1", "--torch-every",
                       "0", *_out(tmp_path, "soak.json")])
    summary = json.loads((tmp_path / "soak.json").read_text())
    assert summary["ranges"] == [[0, 8], [8, 1]]
    assert summary["streams"] == 9 and again["torch_streams"] == 0


def test_parse_scaling_main(tmp_path):
    res = parse_scaling.main(["--slots", "32", "--seconds", "0.2",
                              "--threads", "1", "--trials", "1",
                              *_out(tmp_path, "ps.json")])
    assert res["per_core_frames_per_sec"] > 0
    assert res["harness_frames_per_sec_1t"] > 0
    assert res["stage_stats"]["cycles"]["frame_total"] > 0
    assert res["cores_to_saturate_card"] is None    # no card
    assert parse_scaling.thread_counts(6) == [1, 2, 4, 6]
    assert parse_scaling.thread_counts(8) == [1, 2, 4, 8]


def test_resample_sweep_one_pair(tmp_path):
    res = resample_sweep.main(["--pair", "44100", "48000",
                               *_out(tmp_path, "rs.json")])
    (row,) = res["pairs"]
    assert min(row["snr_1k_db"], row["snr_hi_db"]) >= 85
    assert row["ripple_db"] < 0.1


@pytest.mark.parametrize("tool", [drain_trace, kernel_trace],
                         ids=["drain_trace", "kernel_trace"])
def test_trace_tools(tmp_path, tool):
    out = tmp_path / "trace"
    res = tool.main(["--batch", "16", "--steps", "2", "--device", "cpu",
                     "--out", str(out)])
    assert json.loads((out / "summary.json").read_text()) == res
    assert res["trace_files"]
    assert all((out / f).stat().st_size > 0 for f in res["trace_files"])


def test_tools_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from pdmp3_tpu_torch import tools

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resample_sweep.main(["--pair", "44100", "48000", "--out",
                             "/dev/null"])


@pytest.mark.cuda
def test_tools_on_the_card(tmp_path):
    """The serving diff, the scale simulation, the wire profile and the
    soak at small sizes on the card: each tool's own checks (contracts
    against native, bitwise spot slots, the kernel launches it expects)
    hold, and the launches happened."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    sd = serving_diff.run(16, 300000, dev)
    assert sd["exact"]["native"]["worst_lsb"] == 0
    assert sd["fast"]["launches"] == {
        "fused_granule": 2 * sd["fast"]["steps"]}
    ss = scale_sim.run(256, 4, 2, dev)
    assert "bitwise" in ss["checked"] and ss["max_memory_allocated"] > 0
    from pdmp3_tpu_torch import tools

    before = tools.launches()
    wp = wire_profile.run(wire_profile.corpus(8, 12), 64, 2, 0.1, 1, 0.1,
                          dev)
    assert tools.launched_since(before) == {
        "fused_granule": 2 * wp["decode_steps"],
        "l3_expand": wp["dense_decode_steps"]}
    assert wp["rows"][1]["wire_bytes_per_step"] < \
        wp["rows"][0]["wire_bytes_per_step"]
    sk = soak.run(0, 4, "mpeg1", 2, dev, str(tmp_path))
    assert sk["failures"] == [] and sk["launches"].get("back_half", 0) > 0
