"""Single source of truth for per-engine roofline cost models.

Every ``tc_fraction`` in the bench record rests on hand-written FLOP
models, which have a history of large errors (a 75× wdft undercount, a
linear-probe collapse).  This module is the anchor of their automated
cross-check:

* ``bench.py`` and ``bench/all_configs.py`` import their
  ``flops_per_sample`` numbers from HERE (no inline formulas), and
* ``tests/bench/test_cost_models.py`` stages each non-Pallas engine at a
  representative shape, compiles it, and asserts the model here agrees
  with XLA's own ``compiled.cost_analysis()['flops']`` within a small
  factor (the Pallas kernel — invisible to XLA's counter — is instead
  pinned to its weight-table shapes, which encode the formulation's
  true MAC count).

Conventions:

* All functions return **FLOPs per input sample** (2 FLOPs per MAC),
  BEFORE the pass multiplier.  Multiply by :func:`passes` for the
  bf16 tensor-core roofline (the "high" tier runs 3 bf16 passes,
  DEFAULT 1; "highest" is counted as 6 bf16-equivalent passes).
* "Input sample" is the sample the row's Msps counts — the signal
  entering the engine (so resampler output-side work is scaled by
  up/down).
* XLA's ``cost_analysis()`` counts each dot once at its logical f32
  FLOPs regardless of precision, so the cross-check compares the
  pass-free value returned here.
"""

from __future__ import annotations

import math

PASSES = {"highest": 6, "high": 3, "default": 1}


def passes(precision: str) -> int:
    """bf16 pass multiplier for a given matmul precision."""
    return PASSES[precision]


# ---------------------------------------------------------------------------
# FIR — banded block2 formulation (ops/fir.py)
# ---------------------------------------------------------------------------

def fir_block2_flops_per_sample(ntaps: int) -> float:
    """Banded block2 FIR: each 128-sample output tile contracts a
    ``band_k(ntaps, block)``-row window, so MACs/sample = kb.
    1024 taps → kb = 1152 (1.125× the 1024-MAC ideal — the band is
    rounded up to whole 128-row tiles)."""
    from llzlab_tpu.ops.fir import band_k, block2_block

    kb = band_k(ntaps, block2_block(ntaps))
    return 2.0 * kb


# ---------------------------------------------------------------------------
# Polyphase resampler — dense slab group matmul (ops/resample.py)
# ---------------------------------------------------------------------------

def resample_flops_per_sample(up: int, down: int, k: int,
                              padded: bool = True) -> float:
    """Group matmul ``slab (…, down+k−1) @ Wᵀ (down+k−1, up)``: each
    group of ``down`` input samples costs ``k2·up`` MACs.  ``padded``
    counts a 128-wide contraction padding (147/160/64 → K 223→256); the
    XLA HLO contracts the unpadded k2 (what ``cost_analysis`` sees)."""
    k2 = down + k - 1
    if padded:
        k2 = -(-k2 // 128) * 128
    return 2.0 * k2 * (up / down)


# ---------------------------------------------------------------------------
# Fused FIR+resample composite map (ops/fused_chain.py and the Pallas
# kernel kernels/fused_fir_resample.py)
# ---------------------------------------------------------------------------

def fused_chain_flops_per_sample(ntaps: int, up: int, down: int, k: int,
                                 padded: bool = False) -> float:
    """Composite map: ``nparts = ceil(((k−1)+(ntaps−1))/down) + 1``
    weight blocks of ``(down, up)`` per group of ``down`` inputs →
    ``nparts·up`` MACs/sample (1024 taps, 147/160/64 → 8·147 = 1176).
    ``padded`` counts the kernel's tiles (``down`` and ``up`` rounded up
    to its K chunk and N tile: 147 → 192)."""
    from llzlab_tpu.kernels.fused_fir_resample import _tile_k, _tile_n

    nparts = -(-((k - 1) + (ntaps - 1)) // down) + 1
    if padded:
        bk, bn = _tile_k(down), _tile_n(up)
        return 2.0 * nparts * (-(-down // bk) * bk) * (-(-up // bn) * bn) \
            / down
    return 2.0 * nparts * up


# ---------------------------------------------------------------------------
# FFT engines (ops/transform.py)
# ---------------------------------------------------------------------------

def rfft_dense_flops_per_sample(n: int) -> float:
    """Dense rDFT: one (B, n) @ (n, n/2) cos/sin matmul pair → n
    MACs/sample (DC is a row-sum, not counted)."""
    return 2.0 * n


def rfft_pair_flops_per_sample(n: int) -> float:
    """Pair-output dense rDFT (channelizer frames engine): ONE
    (B, n) @ (n, n+2) matmul with the DC column folded in →
    (n+2) MACs/sample."""
    return 2.0 * (n + 2)


def rfft_real4step_flops_per_sample(n: int) -> float:
    """Real-input four-step (``_rfft_real_core``), n = n1·n2:
    stage A = 2 real dots (n1·n2·n2 each), stage B = Gauss 3-dot
    complex matmul ((n1/2+1)·n1·n2 each), per n-sample frame."""
    from llzlab_tpu.ops.transform import split_factors

    n1, n2 = split_factors(n)
    stage_a = 2.0 * n1 * n2 * n2
    stage_b = 3.0 * (n1 // 2 + 1) * n1 * n2
    return 2.0 * (stage_a + stage_b) / n


def rfft_flops_per_sample(n: int, precision: str) -> float:
    """MACs of the AUTO-resolved rfft engine at this precision
    (ops/transform.py: dense at high/default, real four-step at
    highest)."""
    if precision in ("high", "default"):
        return rfft_dense_flops_per_sample(n)
    return rfft_real4step_flops_per_sample(n)


# ---------------------------------------------------------------------------
# IIR matmul engine (ops/iir_matmul.py)
# ---------------------------------------------------------------------------

def iir_matmul_flops_per_sample(n_sections: int, block_size: int = 254
                                ) -> float:
    """Per section one (L+2, L) triangular-map matmul per L-sample
    block → (L+2) MACs/sample/section (254 → a 256-wide contraction)."""
    return 2.0 * (block_size + 2) * n_sections


# ---------------------------------------------------------------------------
# Windowed-DFT spectral gain stage (ops/spectral.py wdft engine)
# ---------------------------------------------------------------------------

def wdft_flops_per_sample(n_fft: int, hop: int) -> float:
    """Windowed dense rDFT both directions: 2 real dots of
    ``n_fft·(n_fft/2+1)`` per frame per direction, one frame per hop
    input samples (the r4-corrected model — the old four-step-based
    model undercounted 75×)."""
    return 2.0 * 2.0 * 2.0 * n_fft * (n_fft // 2 + 1) / hop


def cwola_flops_per_sample(n_fft: int, hop: int) -> float:
    """Composed-WOLA engine (r5): analysis→static-gain→synthesis as ONE
    (n_fft, n_fft) frame matmul → n² MACs per frame, one frame per hop
    input samples (2.0× fewer MACs than the wdft pair of passes)."""
    return 2.0 * n_fft * n_fft / hop


# ---------------------------------------------------------------------------
# Channelizer chain (chains/channelizer.py)
# ---------------------------------------------------------------------------

def channelizer_flops_per_sample(ntaps: int, up: int, down: int, k: int,
                                 n_fft: int, precision: str,
                                 frames_engine: str = "auto") -> float:
    """Fused FIR+resample (composite map) + the spectral framing engine
    on the resampled stream (scaled by up/down to per-INPUT-sample)."""
    if frames_engine == "pair":
        fft = rfft_pair_flops_per_sample(n_fft)
    else:
        fft = rfft_flops_per_sample(n_fft, precision)
    return (fused_chain_flops_per_sample(ntaps, up, down, k)
            + fft * (up / down))
