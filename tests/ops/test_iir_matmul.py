"""matmul biquad engine vs scipy f64 golden + engine interchange."""

import numpy as np
import pytest
import scipy.signal as ss

import llzlab_tpu as lz
from llzlab_tpu.ops.iir_matmul import sosfilt_matmul


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    return 10 * np.log10(np.sum(ref**2) / np.sum((ref - y) ** 2))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(2).standard_normal((4, 48000)).astype(np.float32)


@pytest.fixture(scope="module")
def sos_eq():
    # The BASELINE.json:9 workload shape: 8-section peaking EQ.
    return lz.peaking_eq_sos(
        [100, 300, 700, 1500, 3000, 6000, 10000, 15000],
        [3, -4, 2, 5, -3, 4, -2, 3], 48000, q=1.0)


class TestSosfiltMatmul:
    def test_eq_cascade_snr(self, x, sos_eq):
        ref = ss.sosfilt(np.asarray(sos_eq, np.float64),
                         x[0].astype(np.float64))
        y = sosfilt_matmul(sos_eq, x)
        assert y.shape == x.shape
        assert _snr(ref, y[0]) > 110.0

    @pytest.mark.parametrize("L", [128, 256])
    def test_block_sizes(self, x, sos_eq, L):
        ref = ss.sosfilt(np.asarray(sos_eq, np.float64),
                         x[0].astype(np.float64))
        y = sosfilt_matmul(sos_eq, x[:1, :4096], block_size=L)
        assert _snr(ref[:4096], y[0]) > 110.0

    def test_real_pole_sections(self, x):
        # Odd-order Butterworth has a real pole → companion path.
        sos = lz.butter_sos(7, 0.3)
        ref = ss.sosfilt(np.asarray(sos, np.float64), x[0].astype(np.float64))
        assert _snr(ref, sosfilt_matmul(sos, x)[0]) > 110.0

    def test_streaming_split(self, x, sos_eq):
        full = np.asarray(sosfilt_matmul(sos_eq, x))
        z0 = np.zeros((4, sos_eq.shape[0], 2), np.float32)
        ya, zf = sosfilt_matmul(sos_eq, x[:, :24000], zi=z0, return_zf=True)
        yb = sosfilt_matmul(sos_eq, x[:, 24000:], zi=zf)
        cat = np.concatenate([np.asarray(ya), np.asarray(yb)], -1)
        assert _snr(full, cat) > 130.0

    def test_state_interchange_with_scan_engine(self, x, sos_eq):
        # zf from the scan engine continues correctly in the matmul engine.
        ref = ss.sosfilt(np.asarray(sos_eq, np.float64),
                         x[0].astype(np.float64))
        z0 = np.zeros((4, sos_eq.shape[0], 2), np.float32)
        ya, zf = lz.sosfilt(sos_eq, x[:, :24000], zi=z0, return_zf=True)
        yb = sosfilt_matmul(sos_eq, x[:, 24000:], zi=zf)
        cat = np.concatenate([np.asarray(ya), np.asarray(yb)], -1)
        assert _snr(ref, cat[0]) > 110.0

    def test_ragged_tail(self, sos_eq):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2, 1000)).astype(np.float32)  # not %128
        ref = ss.sosfilt(np.asarray(sos_eq, np.float64),
                         x[0].astype(np.float64))
        y = sosfilt_matmul(sos_eq, x)
        assert y.shape == (2, 1000)
        assert _snr(ref, y[0]) > 110.0
