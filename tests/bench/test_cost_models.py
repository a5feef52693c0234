"""Cost-model cross-check: the hand FLOP models behind every
``tc_fraction`` in the bench record vs XLA's own counter.

Two model bugs shipped before (a 75× wdft undercount; a linear-probe
collapse).  This file makes a third impossible to ship silently: for
every non-Pallas engine the bench quotes, we stage the
engine at a representative shape, compile it, and assert the model in
``bench/cost_models.py`` (the single source both bench.py and
bench/all_configs.py import) agrees with
``compiled.cost_analysis()['flops']`` within a documented factor.

Conventions (see cost_models.py):
* models return pass-free FLOPs/sample; XLA counts each dot once at its
  logical f32 FLOPs regardless of precision → compare pass-free.
* models may count 128-wide padding that the HLO contraction does not
  show (resample: K 223→256) → the tolerance band is asymmetric,
  [0.95, 1.35]: a model may honestly exceed XLA by the padding factor
  but must never undercount.

The Pallas kernel is invisible to cost_analysis; its model is pinned to
the kernel's weight-table SHAPES, which encode the formulation's true
MAC count (the tables are what the kernel contracts against).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bench import cost_models as cm

LO, HI = 0.95, 1.35


def _xla_flops(fn, *args):
    c = jax.jit(fn).lower(*args).compile()
    ca = c.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca["flops"])


def _check(model_total, xla_total, label):
    ratio = model_total / xla_total
    assert LO <= ratio <= HI, (
        f"{label}: model {model_total:.3e} vs XLA {xla_total:.3e} "
        f"(ratio {ratio:.3f} outside [{LO}, {HI}])"
    )


class TestXlaEngines:
    def test_rfft_dense(self, rng):
        from llzlab_tpu.ops import transform as tr

        b, n = 8, 2048
        x = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32))
        fl = _xla_flops(lambda v: tr._rfft_matmul_jit(v, n, "high",
                                                      "dense"), x)
        _check(b * n * cm.rfft_dense_flops_per_sample(n), fl,
               "rfft dense")

    def test_rfft_pair(self, rng):
        from llzlab_tpu.ops import transform as tr

        b, n = 8, 2048
        x = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32))
        fl = _xla_flops(lambda v: tr._rfft_pair_jit(v, n, "high"), x)
        _check(b * n * cm.rfft_pair_flops_per_sample(n), fl, "rfft pair")

    def test_rfft_real_four_step(self, rng):
        from llzlab_tpu.ops import transform as tr

        b, n = 8, 2048
        x = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32))
        fl = _xla_flops(lambda v: tr._rfft_matmul_jit(v, n, "highest",
                                                      "real"), x)
        _check(b * n * cm.rfft_real4step_flops_per_sample(n), fl,
               "rfft real four-step")

    def test_resample_slab(self, rng):
        import llzlab_tpu as lz

        rtaps = lz.resample_taps(147, 160, 64)
        b, t = 8, 160 * 64
        x = jnp.asarray(rng.standard_normal((b, t)).astype(np.float32))
        fl = _xla_flops(
            lambda v: lz.resample_poly(v, 147, 160, taps=rtaps), x)
        # HLO contracts the unpadded K = down+k−1 = 223
        _check(b * t * cm.resample_flops_per_sample(147, 160, 64,
                                                    padded=False),
               fl, "resample slab (unpadded)")
        # the padded model the bench quotes exceeds the HLO count by
        # exactly the 128-wide padding — keep that factor visible
        pad = (cm.resample_flops_per_sample(147, 160, 64, padded=True)
               / cm.resample_flops_per_sample(147, 160, 64, padded=False))
        assert 1.0 <= pad <= 1.3

    def test_fused_composite(self, rng):
        import llzlab_tpu as lz
        from llzlab_tpu.ops import fused_chain as fc

        taps = lz.firwin(1024, 0.25, window="hamming")
        rtaps = lz.resample_taps(147, 160, 64)
        gparts, hist = fc.fir_resample_tables(taps, 147, 160, rtaps)
        b, t = 4, 160 * 64
        x = jnp.asarray(rng.standard_normal((b, t)).astype(np.float32))
        fl = _xla_flops(lambda v: fc._fir_resample_impl(
            v, gparts, None, up=147, down=160, hist_len=hist,
            return_zf=False), x)
        _check(b * t * cm.fused_chain_flops_per_sample(1024, 147, 160, 64),
               fl, "fused composite")

    def test_iir_matmul(self, rng):
        import llzlab_tpu as lz

        sos8 = lz.peaking_eq_sos(
            [100, 200, 400, 800, 1600, 3200, 6400, 12800],
            [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)
        b, t = 8, 254 * 16
        x = jnp.asarray(rng.standard_normal((b, t)).astype(np.float32))
        fl = _xla_flops(
            lambda v: lz.sosfilt_matmul(sos8, v, precision="high"), x)
        _check(b * t * cm.iir_matmul_flops_per_sample(8), fl,
               "iir matmul 8 sections")

    def test_wdft_stage(self, rng):
        from llzlab_tpu.pipeline.chain import SpectralGainStage

        gain = np.linspace(1.0, 0.5, 1025).astype(np.float32)
        stage = SpectralGainStage(gain, engine="wdft", precision="high")
        b, t = 4, 16384
        x = jnp.asarray(rng.standard_normal((b, t)).astype(np.float32))
        st = stage.init_state((b,))
        fl = _xla_flops(lambda v, s: stage.apply(v, s), x, st)
        _check(b * t * cm.wdft_flops_per_sample(2048, 512), fl,
               "wdft spectral gain stage")

    def test_cwola_stage(self, rng):
        from llzlab_tpu.pipeline.chain import SpectralGainStage

        gain = np.linspace(1.0, 0.5, 1025).astype(np.float32)
        stage = SpectralGainStage(gain, engine="cwola", precision="high")
        b, t = 4, 16384
        x = jnp.asarray(rng.standard_normal((b, t)).astype(np.float32))
        st = stage.init_state((b,))
        fl = _xla_flops(lambda v, s: stage.apply(v, s), x, st)
        _check(b * t * cm.cwola_flops_per_sample(2048, 512), fl,
               "cwola spectral gain stage")


class TestPallasTablePins:
    """The Pallas kernel: the model must equal the MAC count the
    kernel's weight tables encode (cost_analysis cannot see inside a
    pallas_call)."""

    def test_fused_tables_pin_model(self):
        import llzlab_tpu as lz
        from llzlab_tpu.kernels.fused_fir_resample import kernel_tables
        from llzlab_tpu.ops.fused_chain import fir_resample_tables

        taps = lz.firwin(1024, 0.25, window="hamming")
        rtaps = lz.resample_taps(147, 160, 64)
        gparts, _ = fir_resample_tables(taps, 147, 160, rtaps)
        hi, lo = kernel_tables(gparts, "high")
        assert hi.shape == lo.shape
        chunks, bk, up_p = hi.shape
        # every (bk, up_p) chunk is contracted once per group of 160
        # inputs: chunks·bk·up_p MACs per 160 input samples
        from_tables = 2.0 * chunks * bk * up_p / 160.0
        assert cm.fused_chain_flops_per_sample(
            1024, 147, 160, 64, padded=True) == pytest.approx(from_tables)
        assert cm.fused_chain_flops_per_sample(1024, 147, 160, 64) == (
            pytest.approx(2.0 * gparts.shape[0] * 147))

    def test_channelizer_model_composition(self):
        # chain model = fused stage + frames engine scaled to input rate
        base = cm.fused_chain_flops_per_sample(1024, 147, 160, 64)
        pair = cm.channelizer_flops_per_sample(
            1024, 147, 160, 64, 2048, "high", frames_engine="pair")
        assert pair == pytest.approx(
            base + cm.rfft_pair_flops_per_sample(2048) * 147.0 / 160.0)


class TestSingleSource:
    """bench.py and bench/all_configs.py must take every
    flops_per_sample from bench/cost_models.py — inline formulas are
    how the r3/r4 model bugs shipped."""

    @pytest.mark.parametrize("path", ["bench.py", "bench/all_configs.py"])
    def test_harness_imports_cost_models(self, path):
        import os

        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        src = open(os.path.join(root, path)).read()
        assert "cost_models" in src, f"{path} no longer uses cost_models"
        # no resurrected inline pass multipliers
        assert '{"highest": 6, "high": 3' not in src.replace("'", '"'), (
            f"{path} has an inline pass-multiplier table; use "
            "cost_models.passes()")
