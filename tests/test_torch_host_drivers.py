"""The port's native host drivers (pdmp3_tpu_torch/host/build.py), after
tests/test_host_native.py, tests/test_c_abi.py and tests/test_aux.py:

- the ``pdmp3`` CLI writes the same S16LE bytes as the port's
  ``native_decode_file`` and as the JAX package's CLI;
- the threaded-parse selftest finds the threaded parse byte-equal to the
  single-threaded one, and its ThreadSanitizer build reports no race;
- the ASan + UBSan CLI runs clean on hostile inputs;
- the coverage-guided fuzzer builds, finds real coverage from the port's
  seed corpus and survives a mutation burst;
- the parse benchmark and its stage-counter build print their JSON.

Tolerance: none; every comparison is equality.
"""
import json
import random
import subprocess

import pytest

from pdmp3_tpu.host import cli_path as jax_cli_path
from pdmp3_tpu_torch.host import build, cli_path, native_decode_file
from pdmp3_tpu_torch.testing import mp3gen

CLI_STREAMS = {
    "varied_ms_reservoir": dict(n_frames=12, seed=21, blocks="varied",
                                mode=1, mode_extension=2,
                                use_reservoir=True),
    "mono_48k_short": dict(n_frames=10, seed=22, blocks="short", mode=3,
                           sfreq=1),
    "intensity_32k": dict(n_frames=10, seed=23, blocks="mixed", sfreq=2,
                          mode=1, mode_extension=3, intensity_pos=True),
}


def _thread_corpus(tmp_path):
    paths = []
    for i, kw in enumerate((dict(blocks="long"),
                            dict(blocks="short"),
                            dict(blocks="varied", mode=1, mode_extension=2),
                            dict(blocks="mixed", sfreq=2),
                            dict(blocks="long", mode=3),
                            dict(blocks="varied", use_reservoir=True))):
        p = tmp_path / f"s{i}.mp3"
        p.write_bytes(mp3gen.make_stream(n_frames=12, seed=500 + i, **kw))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("name", sorted(CLI_STREAMS))
def test_cli_equals_native_and_the_jax_cli(tmp_path, name):
    stream = mp3gen.make_stream(**CLI_STREAMS[name])
    raws = []
    for tag, exe in (("port", cli_path()), ("jax", jax_cli_path())):
        d = tmp_path / tag
        d.mkdir()
        (d / "in.mp3").write_bytes(stream)
        subprocess.run([exe, str(d / "in.mp3")], check=True, cwd=d,
                       capture_output=True, timeout=120)
        raws.append((d / "in.mp3.raw").read_bytes())
    assert build.CLI == cli_path()
    assert len(raws[0]) > 0
    assert raws[0] == native_decode_file(stream) == raws[1]


def test_threaded_parse_equals_single_thread(tmp_path):
    """pdmp3_parse_step_wire16 with 4 worker threads gives tensors
    byte-identical to the single-threaded parse; 128 slots engage the
    thread pool (fewer than 64 slots parse serially)."""
    r = subprocess.run([build.selftest_bin(), "128", "4", "8",
                        *_thread_corpus(tmp_path)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "threaded parse == single-threaded" in r.stdout


def test_threaded_parse_tsan_clean(tmp_path):
    """The selftest under ThreadSanitizer: no data-race report."""
    r = subprocess.run([build.selftest_bin(sanitize="thread"), "128", "4",
                        "4", *_thread_corpus(tmp_path)],
                       capture_output=True, text=True, timeout=600,
                       env={"TSAN_OPTIONS": "halt_on_error=1"})
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "ThreadSanitizer" not in r.stderr, r.stderr


def test_memory_safety_under_asan(tmp_path):
    """The ASan + UBSan CLI on a VBR reservoir stream, its heavy
    corruption, noise and a truncation: no sanitizer report, exit 0."""
    exe = build.sanitizer_cli("address")
    rng = random.Random(7)
    base = mp3gen.make_stream(n_frames=12, seed=95, blocks="varied",
                              vbr=True, use_reservoir=True)
    corrupt = bytearray(base)
    for i in range(0, len(corrupt), 37):
        corrupt[i] ^= rng.randrange(256)
    cases = [base, bytes(corrupt),
             bytes(rng.randrange(256) for _ in range(8000)),
             base[:len(base) // 2]]
    for i, data in enumerate(cases):
        d = tmp_path / f"case{i}"
        d.mkdir()
        (d / "x.mp3").write_bytes(data)
        r = subprocess.run([exe, str(d / "x.mp3")], cwd=d,
                           capture_output=True, timeout=120)
        assert b"ERROR" not in r.stderr, (i, r.stderr[:2000])
        assert r.returncode == 0, (i, r.returncode, r.stderr[:2000])


def test_fuzzer_smoke(tmp_path):
    """The fuzzer on the port's seed corpus (tools.fuzz.make_seeds):
    real edge coverage, every iteration run, no sanitizer finding."""
    from pdmp3_tpu_torch.tools import fuzz

    seeds = tmp_path / "seeds"
    seeds.mkdir()
    assert fuzz.make_seeds(str(seeds)) >= 31
    p = subprocess.run([build.fuzzer_bin(), str(seeds), "300",
                        str(tmp_path / "cur.bin"), "3"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    assert stats["edges"] > 300
    assert stats["execs"] == 300


@pytest.mark.parametrize("stats", [False, True], ids=["plain", "stats"])
def test_parsebench_prints_its_rate(tmp_path, stats):
    files = _thread_corpus(tmp_path)[:2]
    out = subprocess.run([build.parsebench_bin(stats=stats), "16", "1",
                          "0.05", *files], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    res = json.loads(out)
    assert res["n_slots"] == 16 and res["frames"] > 0
    assert ("cycles" in res) == stats
