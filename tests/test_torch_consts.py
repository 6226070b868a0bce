"""The PyTorch port's constants (pdmp3_tpu_torch/ops/consts.py) against
the JAX package's.

The JAX kernel expands every per-line lookup as a one-hot matrix
([576, 9*K]); the port keeps int16 index maps and gathers.  Each map,
re-expanded to one-hot here, must equal the JAX matrix exactly, and the
back-half tables must equal pallas_step._consts() exactly: no tolerance,
these are the same numbers in another layout.
"""
import numpy as np
import pytest

from pdmp3_tpu import tables as T
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import dsp
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.ops import consts as K


def _onehot_matrix(idx_map: np.ndarray, width: int) -> np.ndarray:
    """[9, 576] index map -> the JAX [576, 9*width] expansion matrix."""
    E = np.zeros((T.N_LAYOUTS, 576, width), np.float32)
    for lay in range(T.N_LAYOUTS):
        E[lay, np.arange(576), idx_map[lay]] = 1.0
    return E.transpose(1, 0, 2).reshape(576, -1)


@pytest.mark.parametrize("name,row,width", [
    ("w_sfb", K.MAP_SFB_L, 22),
    ("w_sfs", K.MAP_SFB_S, 39),
    ("w_sfs_plain", K.MAP_SFB_S_PLAIN, 39),
    ("w_win", K.MAP_WIN, 3),
])
def test_index_maps_reexpand_to_jax_onehots(name, row, width):
    maps = K.line_maps().astype(np.int64)
    want = PSF._front_consts(0)[name]
    np.testing.assert_array_equal(_onehot_matrix(maps[row], width), want)


@pytest.mark.parametrize("name,row", [
    ("w_pre", K.MAP_PRETAB), ("w_short", K.MAP_SHORT),
    ("w_bs", K.MAP_BAND_START), ("w_iok", K.MAP_IOK),
    # the exact kernel's band-12 selects: window per line (wire order)
    # and the short band-12 line mask
    ("w_winline", K.MAP_WIN), ("w_sfb12", K.MAP_SFB12),
])
def test_value_maps_equal_jax_select_matrices(name, row):
    """Value maps ([576, 9] select matrices in JAX: entry = value)."""
    want = PSF._front_consts(0)[name]
    got = K.line_maps()[row].T.astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_back_half_tables_equal_jax_consts():
    c, h = PSF._consts(), K.host_consts()
    np.testing.assert_array_equal(h["cos36"].T, c["cos36_t"])
    np.testing.assert_array_equal(h["c3"].T, c["c3_t"])
    np.testing.assert_array_equal(h["imdct_win"].T, c["win_t"])
    np.testing.assert_array_equal(np.tile(h["win2"], 3)[:, None],
                                  c["win2"])
    np.testing.assert_array_equal(h["nwin"], c["nwin"])
    np.testing.assert_array_equal(h["synth_d"], c["d"])
    np.testing.assert_array_equal(h["inv"].T, c["inv_t"])
    # the stacked basis the fast kernel contracts with
    hyb = c["hyb_left"]
    np.testing.assert_array_equal(hyb[0:36, 0:18], h["cos36"].T)
    np.testing.assert_array_equal(hyb[36:72, 0:18], h["c3"].T)
    np.testing.assert_array_equal(hyb[72:108, 18:22], h["imdct_win"].T)


def test_front_small_tables_equal_jax():
    fc, h = PSF._front_consts(0), K.host_consts()
    for name in ("ratio_l", "ratio_r", "cs", "ca", "quarter_down",
                 "quarter_up"):
        np.testing.assert_array_equal(h[name], fc[name], err_msg=name)
    assert h["inv_sqrt2"].view(np.uint32) == \
        np.float32(fc["inv_sqrt2"]).view(np.uint32)
    # the 16-wide ratios keep the reference's out-of-bounds slots 8..15
    assert h["ratio_l"].shape == (16,) and np.any(h["ratio_l"][8:] != 0)


def test_exact_constants_equal_jax():
    """The band-12 true gains (95 subnormal entries) and the f64 MS
    constant are the JAX package's, bit for bit."""
    h = K.host_consts()
    np.testing.assert_array_equal(
        h["gain_quarter_true"].view(np.uint32),
        np.asarray(T.GAIN_QUARTER_TRUE, np.float32).view(np.uint32))
    g = h["gain_quarter_true"]
    assert ((g > 0) & (g < np.finfo(np.float32).tiny)).sum() == 95
    assert isinstance(K.INV_SQRT2_F64, float)
    assert K.INV_SQRT2_F64 == float(T.INV_SQRT2) == PSF._MS_C


def test_pow43_table_within_2ulp_of_jax_fast_formula():
    """The port reads the correctly rounded |x|^(4/3) table where the JAX
    fast path computes a Newton cube root; over the whole domain the two
    differ by at most 2 ulp (measured on this CPU backend)."""
    import jax.numpy as jnp
    h = K.host_consts()["pow43"]
    np.testing.assert_array_equal(h, np.asarray(T.POW43, np.float32))
    fast = np.asarray(dsp._pow43(jnp.arange(K.POW43_MAX + 1), exact=False),
                      np.float32)
    ulp = np.abs(fast.view(np.int32).astype(np.int64)
                 - h.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2


@pytest.mark.parametrize("B,F", [(1, 1), (6, 1), (8, 2), (127, 1),
                                 (8192, 1), (33, 3)])
def test_soa_layout_offsets_equal_jax(B, F):
    assert TM.soa_layout(B, F) == JM.soa_layout(B, F)
