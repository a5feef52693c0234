"""rfft/irfft engine parity: every engine vs numpy f64 (SURVEY §4.2).

The matmul engine family (dense rDFT, real-input four-step, real-output
inverse, packed-half, real16 factor split) is selected by size and
precision under ``method="matmul"``; these tests pin that every
selectable engine is CORRECT on every platform, so the switch can never
trade away correctness.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llzlab_tpu.ops import transform as tr


def _snr_c(ref, y):
    err = ref - y
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(err) ** 2))


class TestRfftEngines:
    @pytest.mark.parametrize("n", [16, 256, 2048, 4096])
    @pytest.mark.parametrize("eng", ["real", "real16", "dense", "pack"])
    def test_engine_matches_numpy(self, n, eng, rng):
        x = rng.standard_normal((5, n)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        y = np.asarray(tr.rfft_matmul(jnp.asarray(x), n, engine=eng),
                       np.complex128)
        assert y.shape == ref.shape
        assert _snr_c(ref, y) >= 120.0, (n, eng)

    @pytest.mark.parametrize("n", [16, 256, 2048])
    def test_pair_engine_matches_numpy(self, n, rng):
        """rfft_pair: (re, im)-pair layout with the DC column folded
        into ONE combined-table matmul (r5 channelizer frames engine)."""
        x = rng.standard_normal((5, n)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        out = np.asarray(tr.rfft_pair(jnp.asarray(x), n))
        assert out.shape == (5, n + 2)
        h1 = n // 2 + 1
        y = out[..., :h1].astype(np.float64) + 1j * out[..., h1:]
        assert _snr_c(ref, y) >= 120.0, n

    def test_pair_matches_dense_engine(self, rng):
        """Same tables, same contraction: pair == dense to f32 noise,
        and pair_to_complex round-trips the layout."""
        n = 512
        x = rng.standard_normal((4, n)).astype(np.float32)
        dense = np.asarray(tr.rfft_matmul(jnp.asarray(x), n,
                                          engine="dense"))
        out = tr.rfft_pair(jnp.asarray(x), n)
        cplx = np.asarray(tr.pair_to_complex(out))
        assert np.max(np.abs(cplx - dense)) <= 1e-4 * np.max(np.abs(dense))

    def test_auto_resolves_and_matches(self, rng):
        x = rng.standard_normal((3, 2048)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        for scope in ("high", "highest"):
            with tr.precision_scope(scope):
                y = np.asarray(tr.rfft_matmul(jnp.asarray(x), 2048),
                               np.complex128)
            # CPU matmuls are f32 regardless of the precision enum, so
            # both scoped traces must be near-exact
            assert _snr_c(ref, y) >= 120.0, scope


class TestComplexDenseEngine:
    """r5: dense complex DFT (Gauss 3-dot, (n, n) tables) for the
    complex fft/ifft path at small sizes."""

    @pytest.mark.parametrize("n", [16, 256, 1024])
    def test_cdense_matches_numpy(self, n, rng):
        x = (rng.standard_normal((4, n))
             + 1j * rng.standard_normal((4, n))).astype(np.complex64)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        xr = jnp.asarray(x.real)
        xi = jnp.asarray(x.imag)
        orr, oii = tr._fft_matmul_jit(xr, xi, n, "highest", "cdense")
        got = np.asarray(orr, np.float64) + 1j * np.asarray(oii)
        assert _snr_c(ref, got) >= 120.0, n

    def test_cdense_table_cap(self):
        with pytest.raises(ValueError, match="dense complex"):
            tr._cdft_dense_tables(4096)

    def test_fft_ifft_roundtrip_through_auto(self, rng):
        """The public complex fft/ifft (engine resolved by size) must
        round-trip at a size where auto picks cdense."""
        x = (rng.standard_normal((3, 512))
             + 1j * rng.standard_normal((3, 512))).astype(np.complex64)
        y = tr.ifft(tr.fft_matmul(jnp.asarray(x), 512), 512,
                    method="xla")
        # engine mix (matmul fwd, xla inv) — still a valid round trip
        got = np.asarray(jnp.real(y)) + 1j * np.asarray(jnp.imag(y))
        assert _snr_c(x.astype(np.complex128), got) >= 110.0


class TestSizeAwareAuto:
    """The matmul engine choice follows a size×precision table (untuned
    on the GPU until ``bench/sweep.py --suite fftsize`` runs there), and
    the O(n²) dense tables must be capped."""

    @pytest.mark.parametrize("n,prec,expect", [
        (256, "high", "dense"), (2048, "high", "dense"),
        (4096, "high", "pack"), (8192, "high", "real"),
        (16384, "high", "real"),
        (1024, "highest", "dense"), (2048, "highest", "real"),
        (4096, "highest", "pack"), (8192, "highest", "real"),
        (2048, "default", "dense"),
    ])
    def test_auto_table(self, n, prec, expect):
        assert tr._auto_rfft_engine(n, prec) == expect

    @pytest.mark.parametrize("n,prec,expect", [
        (256, "high", "dense"), (1024, "high", "dense"),
        (2048, "high", "pack"), (4096, "high", "real"),
        (8192, "high", "pack"), (16384, "high", "pack"),
        (1024, "highest", "dense"), (2048, "highest", "pack"),
        (4096, "highest", "real"),
    ])
    def test_inverse_auto_table(self, n, prec, expect):
        assert tr._auto_irfft_engine(n, prec) == expect

    @pytest.mark.parametrize("n", [512, 4096, 8192])
    def test_inverse_auto_correct_across_sizes(self, n, rng):
        x = rng.standard_normal((3, n))
        spec = np.fft.rfft(x)
        ref = np.fft.irfft(spec, n)
        for scope in ("high", "highest"):
            with tr.precision_scope(scope):
                y = np.asarray(tr.irfft_matmul(
                    jnp.asarray(spec.astype(np.complex64)), n), np.float64)
            assert _snr_c(ref, y) >= 120.0, (n, scope)

    def test_dense_table_cap_raises(self):
        with pytest.raises(ValueError, match="dense"):
            tr._rdft_dense_tables(8192)
        x = jnp.zeros((2, 8192), jnp.float32)
        with pytest.raises(ValueError, match="dense"):
            tr.rfft_matmul(x, 8192, engine="dense")

    @pytest.mark.parametrize("n", [4096, 8192])
    def test_auto_correct_at_large_sizes(self, n, rng):
        """auto at sizes where it now picks pack/real must stay
        correct on every platform."""
        x = rng.standard_normal((3, n)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        for scope in ("high", "highest"):
            with tr.precision_scope(scope):
                y = np.asarray(tr.rfft_matmul(jnp.asarray(x), n),
                               np.complex128)
            assert _snr_c(ref, y) >= 120.0, (n, scope)


class TestIrfftEngines:
    @pytest.mark.parametrize("n", [16, 256, 2048, 4096])
    @pytest.mark.parametrize("eng", ["real", "dense", "pack"])
    def test_engine_matches_numpy(self, n, eng, rng):
        x = rng.standard_normal((4, n))
        spec = np.fft.rfft(x)
        ref = np.fft.irfft(spec, n)
        y = np.asarray(
            tr.irfft_matmul(jnp.asarray(spec.astype(np.complex64)), n,
                            engine=eng), np.float64)
        assert y.shape == ref.shape
        assert _snr_c(ref, y) >= 120.0, (n, eng)

    def test_roundtrip_all_pairs(self, rng):
        """rfft(engine a) → irfft(engine b) recovers the signal for
        every engine pair (states the two families share conventions —
        bin order, Nyquist handling, scaling)."""
        n = 512
        x = rng.standard_normal((2, n)).astype(np.float32)
        for fe in ("real", "dense", "pack"):
            spec = tr.rfft_matmul(jnp.asarray(x), n, engine=fe)
            for ie in ("real", "dense", "pack"):
                y = np.asarray(tr.irfft_matmul(spec, n, engine=ie),
                               np.float64)
                assert _snr_c(x.astype(np.float64), y) >= 120.0, (fe, ie)


class TestPrecisionThreading:
    def test_static_arg_prevents_stale_trace(self):
        """ADVICE r3 (medium): the same shape traced at two precisions
        must produce two traces — the precision name is a static
        argument of the jitted helpers, not trace-time global state."""
        import jax

        x = jnp.zeros((2, 2048), jnp.float32)
        hi = str(jax.make_jaxpr(
            lambda v: tr._rfft_matmul_jit(v, 2048, "highest", "real"))(x))
        df = str(jax.make_jaxpr(
            lambda v: tr._rfft_matmul_jit(v, 2048, "default", "real"))(x))
        assert "HIGHEST" in hi
        assert "HIGHEST" not in df

    def test_scope_is_case_insensitive(self):
        with tr.precision_scope("HIGHEST"):
            assert tr.matmul_precision_name() == "highest"

    def test_bad_name_raises(self):
        import os

        prev = os.environ.get("LLZ_MATMUL_PRECISION")
        os.environ["LLZ_MATMUL_PRECISION"] = "bogus"
        try:
            with pytest.raises(ValueError):
                tr.matmul_precision_name()
        finally:
            if prev is None:
                del os.environ["LLZ_MATMUL_PRECISION"]
            else:
                os.environ["LLZ_MATMUL_PRECISION"] = prev


class TestWindowedWdft:
    """ops/spectral windowed shifted-matmul STFT/iSTFT parity."""

    def test_windowed_rdft_equals_framed_rfft(self, rng, snr):
        from llzlab_tpu.ops import spectral as sp
        from llzlab_tpu.ops.window import get_window

        n, h = 2048, 512
        x = rng.standard_normal((3, 16384)).astype(np.float32)
        w = get_window("hann", n, periodic=True)
        S = np.asarray(sp.windowed_rdft(jnp.asarray(x), n, h),
                       np.complex64)
        nf = sp.stft_num_frames(x.shape[-1], n, h)
        idx = np.arange(n) + h * np.arange(nf)[:, None]
        ref = np.fft.rfft(x[:, idx] * w, axis=-1)
        assert _snr_c(ref, S) >= 120.0

    def test_windowed_irdft_ola_equals_reference(self, rng):
        from llzlab_tpu.ops import spectral as sp
        from llzlab_tpu.ops.window import get_window

        n, h = 2048, 512
        nf = 13
        spec = (rng.standard_normal((2, nf, n // 2 + 1))
                + 1j * rng.standard_normal((2, nf, n // 2 + 1)))
        # DC/Nyquist imaginary parts are ignored by irfft convention
        spec[..., 0] = spec[..., 0].real
        spec[..., -1] = spec[..., -1].real
        w = get_window("hann", n, periodic=True)
        y = np.asarray(sp.windowed_irdft_ola(
            jnp.asarray(spec.astype(np.complex64)), n, h), np.float64)
        syn = np.fft.irfft(spec, n, axis=-1) * w
        out_len = n + (nf - 1) * h
        ref = np.zeros((2, out_len))
        for i in range(nf):
            ref[:, i * h : i * h + n] += syn[:, i]
        assert _snr_c(ref, y) >= 120.0
