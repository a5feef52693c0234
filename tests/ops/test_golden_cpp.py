"""C++ scalar golden runner vs scipy and vs our ops (SURVEY.md §4.1)."""

import numpy as np
import pytest
import scipy.signal as ss

import llzlab_tpu as lz
from llzlab_tpu import golden


pytestmark = pytest.mark.skipif(
    not golden.available(), reason="golden lib failed to build"
)


class TestGoldenVsScipy:
    def test_fft(self, snr):
        rng = np.random.default_rng(81)
        z = rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
        assert snr(np.fft.fft(z), golden.fft(z)) >= 200.0

    def test_ifft_roundtrip(self, snr):
        rng = np.random.default_rng(82)
        z = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
        assert snr(z, golden.fft(golden.fft(z), inverse=True)) >= 200.0

    def test_fir(self, snr):
        rng = np.random.default_rng(83)
        taps = lz.firwin(1024, 0.25)
        x = rng.standard_normal(20000).astype(np.float32)
        ref = ss.lfilter(taps, [1.0], x.astype(np.float64))
        assert snr(ref, golden.fir(x, taps)) >= 250.0

    def test_sosfilt(self, snr):
        rng = np.random.default_rng(84)
        sos = lz.peaking_eq_sos([200, 2000, 8000], [4, -5, 3], 48000.0)
        x = rng.standard_normal(20000).astype(np.float32)
        ref = ss.sosfilt(sos, x.astype(np.float64))
        assert snr(ref, golden.sosfilt(sos, x)) >= 250.0

    def test_upfirdn(self, snr):
        rng = np.random.default_rng(85)
        h = lz.resample_taps(147, 160, 64)
        x = rng.standard_normal(16000).astype(np.float32)
        ours = golden.upfirdn(h, x, 147, 160)
        ref = ss.upfirdn(h, x.astype(np.float64), 147, 160)[: ours.size]
        assert snr(ref, ours) >= 250.0

    def test_rfft_windowed(self, snr):
        rng = np.random.default_rng(86)
        x = rng.standard_normal(2048).astype(np.float32)
        w = lz.get_window("hann", 2048, periodic=True)
        ref = np.fft.rfft(x.astype(np.float64) * w)
        assert snr(ref, golden.rfft(x, w)) >= 200.0


class TestOpsVsGolden:
    """The acceptance check: device-path ops ≥80 dB vs the C++ serial golden
    on the BASELINE configs (BASELINE.json:5)."""

    def test_fir_config1(self, snr):
        rng = np.random.default_rng(87)
        taps = lz.firwin(1024, 0.25)
        x = rng.standard_normal(48000).astype(np.float32)
        ref = golden.fir(x, taps)
        assert snr(ref, np.asarray(lz.fir_filter(x, taps, method="ols"))) >= 80.0

    def test_iir_config3(self, snr):
        rng = np.random.default_rng(88)
        sos = lz.peaking_eq_sos(
            [100, 200, 400, 800, 1600, 3200, 6400, 12800],
            [3, -4, 5, -2, 6, -3, 2, -5], 48000.0,
        )
        x = rng.standard_normal(48000).astype(np.float32)
        ref = golden.sosfilt(sos, x)
        assert snr(ref, np.asarray(lz.sosfilt(sos, x))) >= 80.0

    def test_resample_config2(self, snr):
        rng = np.random.default_rng(89)
        h = lz.resample_taps(147, 160, 64)
        x = rng.standard_normal(48000).astype(np.float32)
        ref = golden.upfirdn(h, x, 147, 160)
        ours = np.asarray(lz.resample_poly(x, 147, 160, taps=h))
        assert snr(ref[: ours.size], ours) >= 80.0


class TestGoldenWola:
    def test_wola_gain_matches_numpy_f64(self):
        """The C++ serial WOLA golden vs an independent numpy-f64 WOLA
        formulation — both double, different code paths (radix-2
        butterflies vs pocketfft; per-frame loop vs vectorised)."""
        import scipy.signal as ss

        from llzlab_tpu import golden as g

        assert g.available()
        rng = np.random.default_rng(7)
        n_fft, hop = 512, 128
        t = 8 * 512
        x = rng.standard_normal(t).astype(np.float32)
        gain = np.linspace(1.0, 0.25, n_fft // 2 + 1)
        w = ss.get_window("hann", n_fft, fftbins=True).astype(np.float64)
        y = g.wola_gain(x, gain, w, n_fft=n_fft, hop=hop)
        # numpy formulation (the bench's golden)
        nf = 1 + (t - n_fft) // hop
        idx = np.arange(n_fft) + hop * np.arange(nf)[:, None]
        fr = x.astype(np.float64)[idx] * w
        spec = np.fft.rfft(fr, axis=-1) * gain
        syn = np.fft.irfft(spec, n_fft, axis=-1) * w
        out_len = n_fft + (nf - 1) * hop
        ref = np.zeros(out_len)
        env = np.zeros(out_len)
        for i in range(nf):
            ref[i * hop : i * hop + n_fft] += syn[i]
            env[i * hop : i * hop + n_fft] += w * w
        ref = ref / np.maximum(env, 1e-8)
        assert y.shape == ref.shape
        snr = 10 * np.log10(np.sum(ref**2) / np.sum((ref - y) ** 2))
        # ~243 dB: full double agreement (the golden's recurrence
        # twiddles cost a few ulps vs pocketfft's tables)
        assert snr >= 230.0

    def test_cwola_engine_vs_cpp_golden(self):
        """SpectralGainStage's composed-WOLA engine vs the C++ golden
        (interior; the independent-golden closure for config 4)."""
        import jax.numpy as jnp
        import scipy.signal as ss

        from llzlab_tpu import golden as g
        from llzlab_tpu.pipeline.chain import SpectralGainStage

        rng = np.random.default_rng(8)
        t = 16384
        x = rng.standard_normal((1, t)).astype(np.float32)
        gain = np.linspace(1.0, 0.25, 1025).astype(np.float32)
        stage = SpectralGainStage(gain, engine="cwola")
        st = stage.init_state((1,))
        y, st = stage.apply(jnp.asarray(x), st)
        ys = np.concatenate([np.asarray(y), np.asarray(stage.flush(st))],
                            axis=-1)[0, stage.latency:]
        w = ss.get_window("hann", 2048, fftbins=True).astype(np.float64)
        ref = g.wola_gain(x[0], gain.astype(np.float64), w)
        n = min(ys.size, ref.size)
        lo, hi = 2048 + 1536, n - 2 * 2048
        snr = 10 * np.log10(np.sum(ref[lo:hi] ** 2)
                            / np.sum((ref[lo:hi] - ys[lo:hi]) ** 2))
        assert snr >= 90.0
