"""Channelizer fir_method='fused' — FIR + resample as one composite map
(the Pallas kernel on the GPU, the XLA composite on the CPU; the kernel
runs here in interpreter mode): step/streaming parity with the golden and
between engines (SURVEY.md §4.3)."""

import numpy as np
import pytest
import scipy.signal as ss

import jax.numpy as jnp

import llzlab_tpu as lz
from llzlab_tpu.chains.channelizer import Channelizer
from llzlab_tpu.ops import fused_chain as fc


def _mk(fir_method, engine=None):
    chan = Channelizer(
        fir_taps=lz.firwin(256, 0.4),
        up=3,
        down=4,
        fft_n=128,
        taps_per_phase=8,
        fir_method=fir_method,
    )
    if engine is not None:
        chan.fused_engine = engine
    return chan


@pytest.fixture(scope="module")
def snr():
    def f(ref, y):
        ref = np.asarray(ref)
        y = np.asarray(y)
        e = np.abs(ref - y)
        return 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(e**2))

    return f


class TestChannelizerFused:
    def test_block_multiple_matches_program(self):
        chan = _mk("fused")
        m = chan.block_multiple()
        assert m % 4 == 0                 # whole resampler groups
        assert (m * 3 // 4) % 128 == 0    # frames align with fft_n
        assert chan.h_fir == fc.fir_resample_state_len(256, 3, 4, 24)
        assert chan.h_rs == 0

    @pytest.mark.parametrize("engine", ["composite", "pallas"])
    def test_step_vs_scipy_golden(self, snr, engine):
        chan = _mk("fused", engine)
        m = chan.block_multiple()
        c = 8
        rng = np.random.default_rng(90)
        x = rng.standard_normal((c, 2 * m)).astype(np.float32)
        spec, _ = chan.step(jnp.asarray(x), chan.init_state(c))
        y64 = ss.lfilter(chan.fir_taps, [1.0], x.astype(np.float64),
                         axis=-1)
        z64 = np.stack([
            ss.upfirdn(chan.resample_taps, y64[i], 3, 4)
            for i in range(c)
        ])
        nf = spec.shape[1]
        ref = np.fft.rfft(
            z64[:, : nf * 128].reshape(c, nf, 128), axis=-1)
        assert snr(ref, np.asarray(spec)) >= 100.0

    @pytest.mark.parametrize("engine", ["composite", "pallas"])
    def test_streaming_superblock_carry_bit_exact(self, engine):
        chan = _mk("fused", engine)
        m = chan.block_multiple()
        c = 8
        rng = np.random.default_rng(91)
        x = rng.standard_normal((c, 2 * m)).astype(np.float32)
        full, _ = chan.step(jnp.asarray(x), chan.init_state(c))
        s1, st = chan.step(jnp.asarray(x[:, :m]), chan.init_state(c))
        s2, _ = chan.step(jnp.asarray(x[:, m:]), st)
        got = np.concatenate([np.asarray(s1), np.asarray(s2)], axis=1)
        np.testing.assert_array_equal(got, np.asarray(full))

    def test_fallback_low_channels_matches_kernel_math(self, snr):
        """Any channel count runs the kernel (no envelope): c=4 gives
        the same spectra and state as the first 4 of 8 channels, and the
        kernel's state interchanges with the composite's."""
        chan = _mk("fused", "pallas")
        m = chan.block_multiple()
        rng = np.random.default_rng(92)
        x = rng.standard_normal((8, m)).astype(np.float32)
        spec8, st8 = chan.step(jnp.asarray(x), chan.init_state(8))
        spec4, st4 = chan.step(jnp.asarray(x[:4]), chan.init_state(4))
        assert snr(np.asarray(spec8)[:4], np.asarray(spec4)) >= 110.0
        np.testing.assert_array_equal(np.asarray(st4[0]),
                                      np.asarray(st8[0])[:4])
        comp = _mk("fused", "composite")
        s2_k, _ = chan.step(jnp.asarray(x[:4]), st4)
        s2_c, _ = comp.step(jnp.asarray(x[:4]), st4)
        assert snr(np.asarray(s2_c), np.asarray(s2_k)) >= 110.0

    def test_fallback_streaming_carry(self, snr):
        """Odd channel count (c=5): split-and-carry == one-shot."""
        chan = _mk("fused", "pallas")
        m = chan.block_multiple()
        c = 5
        rng = np.random.default_rng(93)
        x = rng.standard_normal((c, 2 * m)).astype(np.float32)
        full, _ = chan.step(jnp.asarray(x), chan.init_state(c))
        s1, st = chan.step(jnp.asarray(x[:, :m]), chan.init_state(c))
        s2, _ = chan.step(jnp.asarray(x[:, m:]), st)
        got = np.concatenate([np.asarray(s1), np.asarray(s2)], axis=1)
        assert snr(np.asarray(full), got) >= 140.0


class TestFirResampleEngines:
    def test_pallas_engine_matches_composite(self, snr):
        taps = lz.firwin(256, 0.3)
        rtaps = lz.resample_taps(3, 4, 8)
        rng = np.random.default_rng(94)
        x = jnp.asarray(
            rng.standard_normal((8, 2048)).astype(np.float32))
        zc = lz.fir_resample(x, taps, 3, 4, rtaps=rtaps,
                             engine="composite")
        zp = lz.fir_resample(x, taps, 3, 4, rtaps=rtaps, engine="pallas",
                             precision="highest")
        assert np.asarray(zp).shape == np.asarray(zc).shape
        assert snr(np.asarray(zc), np.asarray(zp)) >= 110.0

    def test_engine_resolution_cpu(self, monkeypatch):
        from llzlab_tpu.ops import fused_chain

        # CPU backend resolves to the XLA composite, the GPU to the kernel
        assert fused_chain.fir_resample_engine() == "composite"
        monkeypatch.setattr(fused_chain, "backend", lambda: "gpu")
        assert fused_chain.fir_resample_engine() == "pallas"

    @pytest.mark.parametrize("backend,tier,want", [
        ("cpu", "high", "ols"), ("gpu", "high", "fused"),
        ("gpu", "default", "fused"), ("gpu", "highest", "ols")])
    def test_channelizer_auto_per_tier(self, monkeypatch, backend, tier,
                                       want):
        from llzlab_tpu.chains import channelizer

        monkeypatch.setattr(channelizer, "backend", lambda: backend)
        monkeypatch.setenv("LLZ_MATMUL_PRECISION", tier)
        assert channelizer.fir_method_auto() == want
        assert Channelizer(fir_method="auto").fir_method == want

    def test_state_len_per_engine(self):
        # one history length whatever the engine
        assert fc.fir_resample_state_len(1024, 147, 160, 147 * 64) == 1120
        assert fc.fir_resample_state_len(256, 3, 4, 24) == 264

    def test_spec_format_pair_matches_complex(self, snr):
        """spec_format='pair' (r5 frames engine: ONE combined-table
        rDFT matmul) emits the same spectrum as the complex path, in
        the (re, im)-pair layout."""
        rng = np.random.default_rng(91)
        kw = dict(fir_taps=lz.firwin(256, 0.4), up=3, down=4,
                  fft_n=128, taps_per_phase=8, fir_method="fused")
        cc = Channelizer(spec_format="complex", **kw)
        cp = Channelizer(spec_format="pair", **kw)
        m = cc.block_multiple()
        x = rng.standard_normal((8, m)).astype(np.float32)
        spec_c, _ = cc.step(jnp.asarray(x), cc.init_state(8))
        spec_p, _ = cp.step(jnp.asarray(x), cp.init_state(8))
        h1 = cc.fft_n // 2 + 1
        assert spec_p.shape == spec_c.shape[:-1] + (cc.fft_n + 2,)
        pp = np.asarray(spec_p)
        got = pp[..., :h1] + 1j * pp[..., h1:]
        ref = np.asarray(spec_c).astype(np.complex128)
        assert snr(ref, got) >= 120.0

    def test_spec_format_validated(self):
        with pytest.raises(ValueError, match="spec_format"):
            Channelizer(spec_format="nope")
