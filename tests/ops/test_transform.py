"""FFT family: matmul-factored path vs numpy (SURVEY.md §4.2-3)."""

import numpy as np
import jax.numpy as jnp
import pytest

from llzlab_tpu.ops import transform as tf


class TestMatmulFFT:
    @pytest.mark.parametrize("n", [64, 256, 2048, 4096])
    def test_fft_complex(self, n, snr):
        rng = np.random.default_rng(31)
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        ours = np.asarray(tf.fft_matmul(jnp.asarray(z, jnp.complex64)))
        ref = np.fft.fft(z)
        assert snr(ref, ours) >= 100.0

    @pytest.mark.parametrize("n", [256, 2048, 4096])
    def test_rfft(self, n, snr):
        rng = np.random.default_rng(32)
        x = rng.standard_normal((5, n)).astype(np.float32)
        ours = np.asarray(tf.rfft_matmul(jnp.asarray(x)))
        ref = np.fft.rfft(x, axis=-1)
        assert ours.shape == (5, n // 2 + 1)
        assert snr(ref, ours) >= 100.0

    @pytest.mark.parametrize("n", [256, 2048, 4096])
    def test_irfft_roundtrip(self, n, snr):
        rng = np.random.default_rng(33)
        x = rng.standard_normal((3, n)).astype(np.float32)
        spec = np.fft.rfft(x, axis=-1).astype(np.complex64)
        ours = np.asarray(tf.irfft_matmul(jnp.asarray(spec)))
        assert snr(x, ours) >= 100.0

    def test_ifft_inverse(self, snr):
        rng = np.random.default_rng(34)
        z = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048))
        z = jnp.asarray(z, jnp.complex64)
        back = np.asarray(tf.ifft(tf.fft_matmul(z), method="matmul"))
        assert snr(np.asarray(z), back) >= 100.0

    def test_parseval(self):
        rng = np.random.default_rng(35)
        x = rng.standard_normal(4096).astype(np.float32)
        X = np.asarray(tf.fft_matmul(jnp.asarray(x)))
        e_time = np.sum(x.astype(np.float64) ** 2)
        e_freq = np.sum(np.abs(X.astype(np.complex128)) ** 2) / 4096
        assert abs(e_time - e_freq) / e_time < 1e-5

    def test_impulse_is_flat(self):
        x = np.zeros(2048, np.float32)
        x[0] = 1.0
        X = np.asarray(tf.fft_matmul(jnp.asarray(x)))
        np.testing.assert_allclose(X, np.ones(2048, np.complex64), atol=1e-4)

    def test_tone_bin(self):
        n = 2048
        k = 137
        x = np.exp(2j * np.pi * k * np.arange(n) / n).astype(np.complex64)
        X = np.asarray(tf.fft_matmul(jnp.asarray(x)))
        mags = np.abs(X)
        assert np.argmax(mags) == k
        assert mags[k] == pytest.approx(n, rel=1e-5)

    def test_non_pow2_raises(self):
        with pytest.raises(ValueError):
            tf.split_factors(1000)

    def test_linearity_batch(self, snr):
        rng = np.random.default_rng(36)
        x = rng.standard_normal((4, 7, 256)).astype(np.float32)
        ours = np.asarray(tf.rfft_matmul(jnp.asarray(x)))
        ref = np.fft.rfft(x, axis=-1)
        assert snr(ref, ours) >= 100.0


class TestDispatch:
    def test_xla_method(self, snr):
        rng = np.random.default_rng(37)
        x = rng.standard_normal(1000).astype(np.float32)  # non-pow2 ok via xla
        ours = np.asarray(tf.rfft(jnp.asarray(x), method="xla"))
        assert snr(np.fft.rfft(x), ours) >= 100.0

    def test_auto_on_cpu_uses_xla(self, snr):
        rng = np.random.default_rng(38)
        x = rng.standard_normal(2048).astype(np.float32)
        ours = np.asarray(tf.rfft(jnp.asarray(x)))
        assert snr(np.fft.rfft(x), ours) >= 100.0
