"""The two Layer III configurations, now that a configuration names the
modules that know its format: each resolves to the Layer III stream
reader, the Layer III reference and the granule kernels' launch-byte
count; at two seeds its corpus and the reference's frames for its
watched slots read exactly as before the configuration named them
(SHA-256 digests taken with the harness in which the corpus called the
side-information reader and the check the Layer III decode directly);
the named count is the frozen granule count; and a configuration that
names no module, or one that is not there, fails at set-up."""
import hashlib
import json
import shutil

import numpy as np
import pytest

from benchmark import check, corpus, roofline, spec
from benchmark.tests.conftest import ROOT, WORKLOADS

LAYER3 = {"reader": "benchmark.readers.layer3",
          "reference": "benchmark.reference.layer3",
          "kernel.bytes": "benchmark.kernel_bytes.granule"}

# (workload, seed) -> SHA-256 of the corpus (source, rotation, watch,
# feeds) and of the reference's frames for the watched slots, at the
# cell's own traffic mix and slots
DIGESTS = {
    (WORKLOADS[0], 987654321012): (
        "96276d35b45d6771d57b7157c9497442963a44aecc6ad14be720f03b4097a4ce",
        "f0e936056179a1f9cff25874de792aeae5721e2719ac4a2a07d62867f4ffcc0e"),
    (WORKLOADS[1], 987654321012): (
        "66e0ea1936827f15a650225003f4ffe831cb099181bbcd6d2ae6cab474f50485",
        "8af53742b9a0d5e9c1ddc8e0ae473e6c351ba84afebb1013b09b9d37c3c911d1"),
    (WORKLOADS[0], 2147483725): (
        "1aacfd84166f604bdb619cd5e66e6737d954d8de31ac18d59d11c8a82c46acf2",
        "e9496d6cc35f8b48a0eaff26cb0d904fe1d28450151979a7ca46fe9cdf205c1b"),
    (WORKLOADS[1], 2147483725): (
        "f67a71cfdd4675b9c66470b20150ff6f27e4694c18ffacd6d84574ce7400b6d2",
        "49334a325a466ca39e7e5007a40e68b3e7f0c3eb3d1d07aa84d76ab7ca5c250e"),
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_name_the_layer3_modules(workload):
    cfg = spec.cell(workload).config
    for key, module in LAYER3.items():
        assert spec.named(cfg, key).__name__ == module


@pytest.mark.parametrize("workload, seed", sorted(DIGESTS))
def test_cells_read_as_before(workload, seed):
    """Corpus and reference frames (two passes of each loop and three
    frames more) at the digests taken before."""
    cell = spec.cell(workload)
    cfg, tr = cell.config, cell.traffic
    c = corpus.build(cfg["streams"], tr, cfg["pool"]["slots"], seed,
                     spec.named(cfg, "reader"))
    ref = check.Reference(c, spec.named(cfg, "reference"), cfg["format"])
    h = hashlib.sha256()
    for a in (c.source, c.rotation, c.watch):
        h.update(np.asarray(a, np.int64).tobytes())
    for f in c.feeds:
        h.update(len(f).to_bytes(8, "little"))
        h.update(f)
    r = hashlib.sha256()
    for j in range(len(c.watch)):
        r.update(ref.frames(j, 2 * c.period + 3).tobytes())
    assert (h.hexdigest(), r.hexdigest()) == DIGESTS[workload, seed]


@pytest.mark.parametrize("n_slots, n_active",
                         [(8192, 8192), (8192, 0), (12800, 9000)])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_named_count_is_the_granule_count(workload, n_slots, n_active):
    cfg = spec.cell(workload).config
    fmt = cfg["format"]
    assert spec.named(cfg, "kernel.bytes").launch_bytes(
        n_slots, n_active, fmt) == roofline.granule_launch_bytes(
            n_slots, n_active, lsf=bool(fmt["family"]))


def _checkout(tmp_path, edit):
    """A checkout whose MPEG-1 configuration `edit` changed in place."""
    root = tmp_path / "checkout"
    shutil.copytree(f"{ROOT}/benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "streams"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", root)
    path = root / "benchmark" / "configs" / "mp3_44k1_128k_js_fast.json"
    cfg = json.loads(path.read_text())
    edit(cfg)
    path.write_text(json.dumps(cfg))
    return str(root)


def _holder(cfg, key):
    """The entry of cfg that holds the dotted key, and its last part."""
    *outer, last = key.split(".")
    for part in outer:
        cfg = cfg[part]
    return cfg, last


@pytest.mark.parametrize("key", list(spec.NAMED))
def test_a_configuration_naming_no_module_fails_at_setup(tmp_path, key):
    def edit(cfg):
        d, last = _holder(cfg, key)
        del d[last]
    root = _checkout(tmp_path, edit)
    with pytest.raises(ValueError, match=f'names no "{key}"'):
        spec.cell(WORKLOADS[0], root)


@pytest.mark.parametrize("key", list(spec.NAMED))
def test_a_configuration_naming_a_missing_module_fails_at_setup(tmp_path,
                                                                 key):
    def edit(cfg):
        d, last = _holder(cfg, key)
        d[last] = "layer9"
    root = _checkout(tmp_path, edit)
    with pytest.raises(ValueError,
                       match=f'"{key}" names .layer9., and there is no '
                             f"benchmark/{spec.NAMED[key]}/layer9.py"):
        spec.cell(WORKLOADS[0], root)


def test_the_tf32_control_needs_a_reference_with_its_path(monkeypatch):
    from benchmark.reference import layer3
    monkeypatch.delattr(layer3, "TF32")
    with pytest.raises(ValueError, match="reference_tf32 control, and its "
                       "reference benchmark/reference/layer3.py has no TF32"):
        spec.cell("mp3_44k1_128k_js_fast.backend")
    spec.cell("mpeg2_lsf_22k05_64k_exact.backend")   # the program's control
