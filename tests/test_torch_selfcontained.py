"""The port stands alone: no module of ``pdmp3_tpu_torch`` and nothing
``chip_smoke.py`` imports names JAX or the JAX package, the port runs in
an interpreter that cannot import either, and its copies of the JAX
package's JAX-free layers (tables, the native host library, the stream
generator, the metadata layer, the WAV writer, the run-time
configuration, the debug dumps) give the same numbers and bytes as the
originals.

Tolerance: none; every comparison is equality.
"""
import ast
import filecmp
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pdmp3_tpu.tables as JT
import pdmp3_tpu_torch.tables as TT
from pdmp3_tpu.host import PROFILE_LSF
from pdmp3_tpu.host import native_decode_file as jax_native
from pdmp3_tpu.testing import mp3gen as jax_mp3gen
from pdmp3_tpu_torch.host import native_decode_file as port_native
from pdmp3_tpu_torch.testing import mp3gen as port_mp3gen

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                    for p in (REPO / "pdmp3_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
BANNED = ("jax", "pdmp3_tpu")
# streams for the copy checks: MPEG-1 (long, MS + intensity, mono 48 kHz)
# and LSF (MPEG-2 MS + intensity, MPEG-2.5 8 kHz short blocks)
STREAMS = {
    "mpeg1_long": dict(blocks="long"),
    "mpeg1_ms_intensity": dict(blocks="varied", mode=1, mode_extension=3,
                               stereo_extent_ch1=0.3),
    "mpeg1_mono_48k": dict(blocks="mixed", mode=3, sfreq=1),
    "mpeg2_is": dict(family=1, blocks="varied", mode=1, mode_extension=3,
                     stereo_extent_ch1=0.4),
    "mpeg25_8k": dict(family=2, blocks="short", sfreq=2),
}


def _imported_roots(path: Path) -> set:
    """First components of every absolute module an import names."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_neither_jax_nor_the_jax_package(rel):
    assert not _imported_roots(REPO / rel) & set(BANNED)


_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "pdmp3_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import pdmp3_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, "pdmp3_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from pdmp3_tpu_torch.api import decode_file
from pdmp3_tpu_torch.host import PROFILE_LSF, build, native_decode_file
from pdmp3_tpu_torch.testing import mp3gen
assert build.ensure_built().endswith("libpdmp3host_torch.so")
for family, profile, ngr in ((0, 0, 2), (1, PROFILE_LSF, 1)):
    s = mp3gen.make_stream(n_frames=8, seed=5, family=family,
                           mode=1, mode_extension=3)
    d = P.StreamDecoder(1, exact=True, family=family, device="cpu")
    d.feed(0, s)
    assert d.parse_step() == 1
    pcm = d.decode_step()
    assert pcm.shape == (1, 576 * ngr, 2) and pcm.any()
    want = native_decode_file(s, profile=profile)
    assert want[:pcm.nbytes] == pcm.tobytes()
    got = decode_file(s, lsf=family != 0, dsp=P.TorchDSP(device="cpu"))
    assert got == want and len(got) > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                            "pdmp3_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_runs_where_jax_and_the_jax_package_cannot_be_imported():
    """A fresh interpreter whose import system refuses jax and pdmp3_tpu
    imports every port module and chip_smoke, builds the port's host
    library and decodes an MPEG-1 and an LSF stream bitwise equal to the
    port's native decoder, through StreamDecoder and api.decode_file."""
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"


def _table_arrays(mod) -> dict:
    """Every numpy array at module level, and the arrays the table
    builders return for each family."""
    out = {k: v for k, v in vars(mod).items()
           if isinstance(v, np.ndarray)}
    for fam in range(3):
        for fn in ("layout_maps", "stereo_maps"):
            for k, v in getattr(mod, fn)(fam).items():
                out[f"{fn}({fam}).{k}"] = v
    for fn in ("lsf_intensity_tables", "intensity_ratio_tables"):
        for i, v in enumerate(getattr(mod, fn)()):
            out[f"{fn}[{i}]"] = v
    out["freq_inversion_sign"] = mod.freq_inversion_sign()
    return out


def test_tables_copy_equals_the_jax_package_tables():
    want, got = _table_arrays(JT), _table_arrays(TT)
    assert sorted(got) == sorted(want)
    assert len(got) > 40
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=name)
    assert filecmp.cmp(REPO / "pdmp3_tpu/_data/tables.npz",
                       REPO / "pdmp3_tpu_torch/_data/tables.npz",
                       shallow=False)


@pytest.mark.parametrize("rel", ["include/pdmp3.h", "src/internal.h",
                                 "src/gen_tables.inc", "src/tables.cc",
                                 "src/frame.cc", "src/dsp.cc",
                                 "src/api.cc", "src/main.cc",
                                 "src/selftest.cc", "src/parsebench.cc",
                                 "src/fuzz_main.cc"])
def test_host_sources_are_copies(rel):
    """The port's host library and its drivers (the CLI, the threaded
    selftest, the parse benchmark, the fuzzer) are built from
    byte-identical sources, so its handle blobs (checkpoints) and its
    output are the JAX package's."""
    assert filecmp.cmp(REPO / "pdmp3_tpu/host" / rel,
                       REPO / "pdmp3_tpu_torch/host" / rel, shallow=False)


@pytest.mark.parametrize("rel", ["metadata.py", "utils/wav.py",
                                 "utils/config.py", "utils/dumps.py",
                                 "testing/signals.py",
                                 "testing/mpg123ref.py"])
def test_jax_free_modules_are_copies(rel):
    """The stream metadata layer (tags, frame index, seek plans, gapless
    bounds), the WAV writer, the run-time configuration, the debug
    dumps, the program material for real encoders and the libmpg123
    binding are byte-identical copies: their imports (tables, frontend,
    host) resolve to the port's own copies."""
    assert filecmp.cmp(REPO / "pdmp3_tpu" / rel,
                       REPO / "pdmp3_tpu_torch" / rel, shallow=False)


@pytest.mark.parametrize("name", ["av_oracle.c", "av_encode.c",
                                  "av_encmux.c", "av_remux.c"])
def test_av_sources_are_copies(name):
    """The port's libav helpers (testing/avref.py) build from
    byte-identical copies of the JAX package's tools/av_*.c."""
    assert filecmp.cmp(REPO / "tools" / name,
                       REPO / "pdmp3_tpu_torch/testing/csrc" / name,
                       shallow=False)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_decode_and_generator_copies_are_byte_equal(name):
    """The port's mp3gen makes the same bytes as the JAX package's, and
    the port's native library decodes them to the same PCM."""
    kw = STREAMS[name]
    data = port_mp3gen.make_stream(n_frames=6, seed=11, **kw)
    assert data == jax_mp3gen.make_stream(n_frames=6, seed=11, **kw)
    profile = PROFILE_LSF if kw.get("family") else 0
    got = port_native(data, profile=profile)
    assert len(got) > 0 and got == jax_native(data, profile=profile)
