"""Time-sharded spectral-gain chain vs unsharded (SURVEY.md §4.4)."""

import numpy as np
import jax.numpy as jnp
import pytest

import llzlab_tpu as lz
from llzlab_tpu.parallel.mesh import make_dsp_mesh
from llzlab_tpu.parallel.spectral_sp import spectral_gain_sharded


@pytest.fixture(scope="module")
def mesh24():
    return make_dsp_mesh(2, 4)


class TestSpectralGainSharded:
    def test_matches_unsharded_interior(self, mesh24, snr):
        rng = np.random.default_rng(111)
        x = rng.standard_normal((8, 4 * 4096)).astype(np.float32)
        gain = np.ones(1025, np.float32)
        gain[100:200] = 0.25
        y_sh = np.asarray(spectral_gain_sharded(jnp.asarray(x), gain, mesh24))
        spec = lz.stft(x, n_fft=2048, hop=512)
        y_ref = np.asarray(
            lz.istft(spec * gain, n_fft=2048, hop=512, length=x.shape[-1])
        )
        t = x.shape[-1]
        # Interior matches the unsharded chain; the final n_fft samples
        # see extra zero-padded frames on the last shard (documented).
        assert snr(y_ref[:, : t - 2048], y_sh[:, : t - 2048]) >= 130.0

    def test_unity_gain_reconstructs(self, mesh24, snr):
        rng = np.random.default_rng(112)
        x = rng.standard_normal((4, 4 * 4096)).astype(np.float32)
        y = np.asarray(
            spectral_gain_sharded(
                jnp.asarray(x), np.ones(1025, np.float32), mesh24
            )
        )
        assert snr(x[:, 2048:-2048], y[:, 2048:-2048]) >= 130.0

    def test_notch_kills_tone(self, mesh24):
        fs, n_fft, hop = 48000.0, 2048, 512
        k = 150
        t = np.arange(4 * 4096) / fs
        x = np.tile(
            np.sin(2 * np.pi * (k * fs / n_fft) * t).astype(np.float32),
            (8, 1),
        )
        gain = np.ones(n_fft // 2 + 1, np.float32)
        gain[140:160] = 0.0
        y = np.asarray(spectral_gain_sharded(jnp.asarray(x), gain, mesh24))
        mid = y[:, 4096:-4096]
        assert np.sqrt(np.mean(mid**2)) < 1e-3

    def test_cwola_engine_matches_reference_engine(self, mesh24, snr):
        """The sharded path's composed-WOLA engine (forced: auto
        resolves to the reference engine) must match the framed
        reference engine everywhere, including shard boundaries."""
        rng = np.random.default_rng(113)
        x = rng.standard_normal((8, 4 * 4096)).astype(np.float32)
        gain = np.linspace(1.0, 0.25, 1025).astype(np.float32)
        y_ref = np.asarray(spectral_gain_sharded(
            jnp.asarray(x), gain, mesh24, engine="reference"))
        y_cw = np.asarray(spectral_gain_sharded(
            jnp.asarray(x), gain, mesh24, engine="cwola"))
        assert snr(y_ref, y_cw) >= 90.0

    def test_cwola_engine_rejects_callable(self, mesh24):
        with pytest.raises(ValueError, match="cwola"):
            spectral_gain_sharded(
                jnp.zeros((4, 4 * 4096), jnp.float32),
                lambda s: 1.0, mesh24, engine="cwola")
