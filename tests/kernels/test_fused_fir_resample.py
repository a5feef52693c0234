"""Fused FIR+resample Pallas kernel (Triton route, interpret mode) vs the
composite engine it replaces, the scipy f64 golden and its own streaming
split (SURVEY.md §4.2-4.3)."""

import numpy as np
import pytest
import scipy.signal as ss

import jax.numpy as jnp

from llzlab_tpu.kernels import fused_fir_resample as ff
from llzlab_tpu.ops import fir as fir_mod
from llzlab_tpu.ops import fused_chain as fc
from llzlab_tpu.ops import resample as rs_mod
from tests.conftest import snr_db

NTAPS, UP, DOWN, K = 129, 3, 4, 8


def _design(ntaps, up, down, k):
    taps = fir_mod.firwin(ntaps, 0.2, window="hamming")
    rtaps = rs_mod.resample_taps(up, down, k)
    return taps, rtaps


def _both(x, taps, up, down, rtaps, mode, zi=None):
    kw = dict(rtaps=rtaps, precision=mode, zi=zi, return_zf=True)
    zc, fc_ = fc.fir_resample(x, taps, up, down, engine="composite", **kw)
    zp, fp = fc.fir_resample(x, taps, up, down, engine="pallas", **kw)
    return (np.asarray(zc), np.asarray(fc_)), (np.asarray(zp), np.asarray(fp))


# (ntaps, up, down, taps/phase, channels, T): ragged T (not a multiple of
# down or of the tiles), down below the K chunk, up below the N tile, and
# the headline 147/160 ratio at a small length.
CASES = [
    (129, 3, 4, 8, 3, 1000),
    (33, 2, 3, 4, 1, 97),
    (255, 1, 2, 8, 2, 3001),
    (64, 5, 7, 6, 4, 700),
    (1024, 147, 160, 64, 2, 4000),
    (256, 147, 160, 16, 1, 1601),
]


@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("ntaps,up,down,k,c,t", CASES)
def test_kernel_matches_composite(rng, ntaps, up, down, k, c, t, mode):
    taps, rtaps = _design(ntaps, up, down, k)
    x = rng.standard_normal((c, t)).astype(np.float32)
    hlen = fc.fir_resample_state_len(ntaps, up, down, len(rtaps))
    zi = rng.standard_normal((c, hlen)).astype(np.float32)
    (zc, fc_), (zp, fp) = _both(x, taps, up, down, rtaps, mode, zi=zi)
    assert zp.shape == zc.shape == (c, rs_mod.resample_output_len(t, up, down))
    assert snr_db(zc, zp) >= (125.0 if mode == "highest" else 100.0)
    np.testing.assert_array_equal(fp, fc_)  # same history contract


@pytest.mark.parametrize("mode", ["high", "highest"])
def test_kernel_matches_golden(rng, mode):
    taps, rtaps = _design(NTAPS, UP, DOWN, K)
    x = rng.standard_normal((2, 2400)).astype(np.float32)
    z = np.asarray(fc.fir_resample(x, taps, UP, DOWN, rtaps=rtaps,
                                   engine="pallas", precision=mode))
    y64 = ss.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    z64 = ss.upfirdn(rtaps, y64, UP, DOWN, axis=-1)[:, : z.shape[-1]]
    assert snr_db(z64, z) >= (120.0 if mode == "highest" else 95.0)


@pytest.mark.parametrize("mode", ["high", "highest"])
def test_streaming_split_bitexact(rng, mode):
    """Splitting at a multiple of ``down`` and carrying zf reproduces the
    one-shot output bit-for-bit (same operands, same tile order)."""
    taps, rtaps = _design(NTAPS, UP, DOWN, K)
    x = rng.standard_normal((3, 1200)).astype(np.float32)
    kw = dict(rtaps=rtaps, engine="pallas", precision=mode)
    full = fc.fir_resample(x, taps, UP, DOWN, **kw)
    cut = 4 * 97
    a, zf = fc.fir_resample(x[:, :cut], taps, UP, DOWN, return_zf=True,
                            **kw)
    b = fc.fir_resample(x[:, cut:], taps, UP, DOWN, zi=zf, **kw)
    np.testing.assert_array_equal(
        np.asarray(full), np.concatenate([a, b], axis=-1))


def test_history_only_input(rng):
    """Zero signal, nonzero history: only the history loads contribute."""
    taps, rtaps = _design(NTAPS, UP, DOWN, K)
    hlen = fc.fir_resample_state_len(NTAPS, UP, DOWN, len(rtaps))
    x = np.zeros((2, 400), np.float32)
    zi = rng.standard_normal((2, hlen)).astype(np.float32)
    (zc, _), (zp, _) = _both(x, taps, UP, DOWN, rtaps, "highest", zi=zi)
    assert np.abs(zc).max() > 0
    assert snr_db(zc, zp) >= 125.0


def test_batch_shape_preserved(rng):
    taps, rtaps = _design(NTAPS, UP, DOWN, K)
    x = rng.standard_normal((2, 3, 800)).astype(np.float32)
    z = fc.fir_resample(x, taps, UP, DOWN, rtaps=rtaps, engine="pallas")
    zc = fc.fir_resample(x, taps, UP, DOWN, rtaps=rtaps, engine="composite")
    assert z.shape == zc.shape == (2, 3, 600)
    assert snr_db(np.asarray(zc), np.asarray(z)) >= 125.0


def test_state_len_matches_history_reach():
    """One history length for every engine, covering the composite
    window's reach before the group start."""
    rtaps_len = 147 * 64
    h = fc.fir_resample_state_len(1024, 147, 160, rtaps_len)
    gparts, hist_len = fc.fir_resample_tables(
        fir_mod.firwin(1024, 0.25), 147, 160,
        rs_mod.resample_taps(147, 160, 64))
    assert h == hist_len == 1120
    assert h % 160 == 0 and h >= (64 - 1) + (1024 - 1)
    assert gparts.shape == (8, 160, 147)


@pytest.mark.parametrize("down,up,bk,bn", [
    (160, 147, 32, 64), (4, 3, 16, 16), (2, 1, 16, 16), (40, 20, 32, 32)])
def test_tiles_and_table_padding(down, up, bk, bn):
    assert (ff._tile_k(down), ff._tile_n(up)) == (bk, bn)
    g = np.random.default_rng(0).standard_normal((3, down, up))
    hi, lo = ff.kernel_tables(g, "high")
    nk = -(-down // bk)
    assert hi.shape == lo.shape == (3 * nk, bk, -(-up // bn) * bn)
    back = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
    back = back.reshape(3, nk * bk, -1)
    np.testing.assert_allclose(back[:, :down, :up], g, rtol=2e-5)
    assert not back[:, down:, :].any() and not back[:, :, up:].any()


@pytest.mark.parametrize("mode", ["high", "highest"])
def test_split_pieces(mode):
    g = np.random.default_rng(1).standard_normal((2, 32, 64))
    tabs = ff.kernel_tables(g, mode)
    if mode == "highest":   # one float32 table, the TF32x3 product's input
        assert len(tabs) == 1 and tabs[0].dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(tabs[0]).reshape(g.shape),
                                      g.astype(np.float32))
        return
    v = jnp.asarray(g.ravel(), jnp.float32)
    hi, lo = ff._split(v)
    assert hi.dtype == lo.dtype == jnp.bfloat16
    rel = float(jnp.max(jnp.abs(hi.astype(jnp.float32)
                                + lo.astype(jnp.float32) - v)
                        / jnp.abs(v)))
    assert rel < 2.0 ** -15
    w_hi, w_lo = tabs
    back = np.asarray(w_hi, np.float64) + np.asarray(w_lo, np.float64)
    np.testing.assert_allclose(back.reshape(g.shape), g, rtol=2e-5)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="precision mode"):
        ff.kernel_tables(np.zeros((2, 4, 3)), "fast")


def test_default_tier_maps_to_high(rng):
    taps, rtaps = _design(NTAPS, UP, DOWN, K)
    x = rng.standard_normal((1, 400)).astype(np.float32)
    kw = dict(rtaps=rtaps, engine="pallas")
    a = fc.fir_resample(x, taps, UP, DOWN, precision="default", **kw)
    b = fc.fir_resample(x, taps, UP, DOWN, precision="high", **kw)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stage_pallas_rejects_bad_batch(rng):
    """The kernel has no channel envelope any more: a stage built with
    engine='pallas' runs any batch, including the odd ones the former
    kernel refused, and matches the composite stage."""
    from llzlab_tpu.pipeline.chain import FusedFirResampleStage

    taps = fir_mod.firwin(NTAPS, 0.2, window="hamming")
    x = jnp.asarray(rng.standard_normal((5, 400)).astype(np.float32))
    out = {}
    for engine in ("pallas", "composite"):
        stage = FusedFirResampleStage(taps, UP, DOWN, taps_per_phase=K,
                                      engine=engine)
        out[engine], _ = stage.apply(x, stage.init_state((5,)))
    assert snr_db(np.asarray(out["composite"]),
                  np.asarray(out["pallas"])) >= 125.0
