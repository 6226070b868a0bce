"""The port's one launch path (pdmp3_tpu_torch/ops/launch.py) on the CPU.

``tools.launches()`` names exactly the 20 kernel counters, every
``kernel.counter`` a benchmark configuration reads among them (the
benchmark's traced run holds the profiler's launches to that count);
``launch`` against a stand-in kernel library counts one launch on
success and none on failure, where it raises with the kernel's name and
the library's error string; no wrapper module keeps a counter of its
own; K9's wrapper refuses operands through the shared checks."""
import glob
import importlib
import json
import os

import pytest
import torch

from pdmp3_tpu_torch import tools
from pdmp3_tpu_torch.ops import _build
from pdmp3_tpu_torch.ops import l12_requant as RQ
from pdmp3_tpu_torch.ops import launch as LA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("fused_granule", "fused_granule_exact", "fused_granule_lsf",
         "fused_granule_lsf_exact", "fused_granule_float",
         "fused_granule_float_exact", "fused_granule_lsf_float",
         "fused_granule_lsf_float_exact", "back_half", "back_half_raw",
         "rounding_sweep", "frame_fused", "frame_fused_lsf", "l12_synth",
         "l12_synth_exact", "l12_synth_float", "l12_synth_float_exact",
         "l12_requant", "resample", "l3_expand")
WRAPPERS = ("fused_step", "back_half", "frame_step", "l12_synth",
            "l12_requant", "l3_expand", "resample", "rounding")


def test_launches_names_the_19_kernels():
    """Every name, in order, zeros included (K10's ``l3_expand`` made
    them 20); a snapshot differs from itself in nothing."""
    got = tools.launches()
    assert tuple(got) == NAMES == LA.KERNELS
    assert tools.launched_since(got) == {}


def test_benchmark_counters_are_kernel_names():
    """The counter each benchmark configuration's traced check reads is
    one of the names (the configurations are read, not changed)."""
    paths = sorted(glob.glob(os.path.join(ROOT, "benchmark", "configs",
                                          "*.json")))
    assert paths
    for path in paths:
        with open(path) as f:
            counter = json.load(f)["kernel"]["counter"]
        assert counter in tools.launches(), (path, counter)


class _Library:
    """A stand-in kernel library: one entry point that records its
    arguments and returns `rc`, and the error strings."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def pdmp3_stand_in(self, *args):
        self.calls.append(args)
        return self.rc

    @staticmethod
    def pdmp3_cuda_error_string(rc):
        return f"stand-in error {rc}".encode()


class _Stream:
    cuda_stream = 0x5eed


class _Guard:
    """A stand-in device guard that records its device."""
    entered = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _Guard.entered.append(self.device)

    def __exit__(self, *exc):
        return False


@pytest.fixture
def stand_in(monkeypatch):
    """Give a stand-in library (``_build.load``), device guard and
    current stream (there is no card here); the counts are restored
    afterwards."""
    def load(rc):
        lib = _Library(rc)
        monkeypatch.setattr(_build, "load", lambda: lib)
        return lib
    _Guard.entered = []
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: _Stream())
    for k in LA.KERNELS:
        monkeypatch.setitem(LA.LAUNCHES, k, LA.LAUNCHES[k])
    return load


def test_launch_counts_one_on_success(stand_in):
    """The entry point gets the arguments and the device's current
    stream last, under the device's guard; one count, of that kernel
    only."""
    lib = stand_in(0)
    before = tools.launches()
    LA.launch("resample", "pdmp3_stand_in", "cuda:3", 1, 2.5, None)
    assert lib.calls == [(1, 2.5, None, _Stream.cuda_stream)]
    assert _Guard.entered == ["cuda:3"]
    assert tools.launched_since(before) == {"resample": 1}


def test_launch_failure_raises_and_counts_nothing(stand_in):
    """A nonzero return raises RuntimeError naming the kernel and
    carrying the library's error string; no count moves."""
    stand_in(700)
    before = tools.launches()
    with pytest.raises(RuntimeError,
                       match=r"^resample launch failed: stand-in error 700$"):
        LA.launch("resample", "pdmp3_stand_in", "cuda:0")
    assert tools.launched_since(before) == {}


def test_reset_zeroes_every_count(monkeypatch):
    for k in LA.KERNELS:
        monkeypatch.setitem(LA.LAUNCHES, k, 3)
    LA.reset()
    assert set(tools.launches().values()) == {0}


@pytest.mark.parametrize("module", WRAPPERS)
def test_wrappers_keep_no_counter_of_their_own(module):
    """The wrapper modules hold no launch counter and call no error
    string themselves: both are ops.launch's."""
    mod = importlib.import_module(f"pdmp3_tpu_torch.ops.{module}")
    assert not [k for k in vars(mod) if k.startswith("LAUNCHES")]
    with open(mod.__file__) as f:
        assert "pdmp3_cuda_error_string" not in f.read()


def _k9_operands(F=1, B=2):
    return (torch.zeros((F, B, RQ.BODY_BYTES), dtype=torch.uint8),
            torch.zeros((F, B, RQ.SIDE_BYTES), dtype=torch.uint8),
            torch.zeros((F, B, 2), dtype=torch.int16))


@pytest.mark.parametrize("bad", ["side_dtype", "geom_shape", "out_shape",
                                 "geom_strided", "body_rank"])
def test_k9_refuses_operands(bad):
    """l12_requant refuses a wrong dtype or shape, a strided operand and
    a body of the wrong rank with ValueError (check_operands), on the
    CPU as on the card."""
    body, side, geom = _k9_operands()
    out = None
    if bad == "side_dtype":
        side = side.to(torch.int16)
    elif bad == "geom_shape":
        geom = geom[:, :1]
    elif bad == "out_shape":
        out = torch.zeros((1, 2, 2, 12, 32))
    elif bad == "geom_strided":
        geom = torch.zeros((1, 2, 4), dtype=torch.int16)[..., ::2]
    else:
        body = body[0]
    with pytest.raises(ValueError):
        RQ.l12_requant(body, side, geom, 2, out)


@pytest.mark.cuda
def test_k9_refuses_misaligned_body_and_side_on_cuda():
    """On the card, a body or side off 16-byte alignment raises
    ValueError (check_bulk_alignment) before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for i, name in enumerate(("body", "side")):
        ops = [t.to(dev) for t in _k9_operands()]
        flat = torch.zeros(ops[i].numel() + 1, dtype=torch.uint8,
                           device=dev)
        ops[i] = flat[1:].view(ops[i].shape)
        n0 = LA.LAUNCHES["l12_requant"]
        with pytest.raises(ValueError, match=f"^{name} must be 16-byte"):
            RQ.l12_requant(*ops, 2)
        assert LA.LAUNCHES["l12_requant"] == n0


def test_k9_device_tables_are_made_once_a_device():
    """K9's class tables on a device are one cached set."""
    a = RQ.device_tables("cpu")
    assert RQ.device_tables("cpu") is a
    assert set(a) == {"cd", "ci", "scf"}
