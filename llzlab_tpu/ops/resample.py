"""Polyphase rational resampling (e.g. 48 kHz ↔ 44.1 kHz = 147/160).

Capability parity target: the reference's ``llz_resample.c/h`` (streaming
polyphase FIR bank with per-output phase walk; mount empty — spec anchors
BASELINE.json:5 "polyphase rational resampling" and BASELINE.json:8
"147/160, 64 taps/phase, 8 channels").

Design: the serial phase walk

    y[m] = Σ_j h[L·j + (m·M mod L)] · x[m·M//L − j]

is a gather-free matmul when outputs are grouped L at a time.  For output
group ``s`` (outputs m = L·s+p), every window lives inside the slab
``x[s·M − (K−1) .. s·M + M − 1]`` of ``M+K−1`` samples.  Scattering each
phase's ``K`` taps into a dense ``(L, M+K−1)`` weight matrix ``W`` (done
once, on host) turns the whole group into one matmul:

    y[s, :] = slab[s, :] @ W.T        # (S, M+K−1) @ (M+K−1, L)

For 147/160 × 64 taps that is a (·,223)×(223,147) matmul — 3.5× zero
padding in FLOPs, fully dense, zero gathers, matmul-bound.  Numerics are
identical to ``scipy.signal.upfirdn(h, x, L, M)`` truncated to
``ceil(T·L/M)`` outputs (causal, zero initial history).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops.fir import firwin

__all__ = [
    "resample_taps",
    "polyphase_weights",
    "resample_poly",
    "resample_output_len",
    "resample_halo",
    "decimate",
    "resample",
]


def resample(x: jnp.ndarray, num: int, *, window=None) -> jnp.ndarray:
    """Fourier-domain resampling to exactly ``num`` samples along the last
    axis (scipy.signal.resample semantics for real input).

    The rFFT spectrum is truncated / zero-extended to the new rate with
    scipy's Nyquist-bin split, optionally shaped by ``window`` (a
    :func:`llzlab_tpu.ops.window.get_window` spec applied to the full
    spectrum in fftshift order).  Best for periodic signals; for streaming
    rational ratios use :func:`resample_poly`.
    """
    from llzlab_tpu.ops.window import get_window

    t = x.shape[-1]
    num = int(num)
    if window is not None:
        w_full = np.fft.ifftshift(get_window(window, t, periodic=True))
        # fold negative-frequency window halves onto the rfft bins
        w_real = w_full.copy()
        w_real[1:] += w_full[-1:0:-1]
        w_real[1:] *= 0.5
        w = jnp.asarray(w_real[: t // 2 + 1].astype(np.float32))
    else:
        w = None
    return _resample_impl_fft(x, w, num=num, t=t)


@functools.partial(jax.jit, static_argnames=("num", "t"))
def _resample_impl_fft(x, w, *, num: int, t: int):
    from llzlab_tpu.ops import transform as _tf

    spec = _tf.rfft(x.astype(jnp.float32), t)
    if w is not None:
        spec = spec * w
    n = min(num, t)
    nyq = n // 2 + 1
    out_bins = num // 2 + 1
    y = jnp.zeros(x.shape[:-1] + (out_bins,), spec.dtype)
    y = y.at[..., :nyq].set(spec[..., :nyq])
    if n % 2 == 0:
        if num < t:
            # folding the (dropped) negative Nyquist partner back in
            y = y.at[..., n // 2].multiply(2.0)
        elif num > t:
            # the old Nyquist bin splits between ±N/2 of the longer signal
            y = y.at[..., n // 2].multiply(0.5)
    out = _tf.irfft(y, num)
    return (out * (num / t)).astype(x.dtype)


def decimate(
    x: jnp.ndarray,
    q: int,
    *,
    taps_per_phase: int = 64,
    window=("kaiser", 8.0),
) -> jnp.ndarray:
    """Anti-aliased integer downsampling by ``q`` (FIR polyphase path).

    Equivalent to ``resample_poly(x, 1, q)`` with a stopband-at-Nyquist
    lowpass — the FIR analog of scipy.signal.decimate(ftype="fir").
    """
    return resample_poly(
        x, 1, q, taps_per_phase=taps_per_phase, window=window
    )


def resample_output_len(t: int, up: int, down: int) -> int:
    """Number of causal outputs for t inputs: ceil(t·up/down)."""
    return -(-t * up // down)


def resample_halo(taps_per_phase: int) -> int:
    """Input history samples a shard needs from its left neighbour."""
    return taps_per_phase - 1


def resample_taps(
    up: int,
    down: int,
    taps_per_phase: int = 64,
    *,
    window=("kaiser", 8.0),
    stopband_at_nyquist: bool = True,
) -> np.ndarray:
    """Prototype lowpass for an up/down polyphase bank, float64.

    Length ``up·taps_per_phase``, passband gain ``up`` (to conserve
    amplitude through zero-stuffing).  With ``stopband_at_nyquist`` (the
    default) the −6 dB point is shifted *below* the tighter Nyquist by half
    the Kaiser transition width so the full stopband attenuation is reached
    at the fold frequency — otherwise aliases in the transition band leak
    through (e.g. a 23 kHz tone into 44.1 kHz would only see ~−22 dB).
    """
    n = up * taps_per_phase
    cutoff = 1.0 / max(up, down)
    if stopband_at_nyquist:
        if isinstance(window, tuple) and window[0].lower() == "kaiser":
            beta = float(window[1])
            atten = beta / 0.1102 + 8.7  # inverse of the Kaiser β formula
        else:
            atten = 60.0
        # Kaiser: N ≈ (A − 7.95)/(2.285·Δω); in Nyquist units Δf = Δω/π.
        trans = (atten - 7.95) / (2.285 * n) / np.pi
        cutoff = max(cutoff - trans / 2.0, cutoff * 0.5)
    h = firwin(n, cutoff, window=window)
    return h * up


@functools.lru_cache(maxsize=32)
def _phase_layout(up: int, down: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group phase table: r[p] = (p·down) % up, q[p] = (p·down) // up."""
    p = np.arange(up)
    return (p * down) % up, (p * down) // up


def polyphase_weights(h: np.ndarray, up: int, down: int) -> np.ndarray:
    """Dense ``(up, down + K − 1)`` group weight matrix from prototype taps.

    ``W[p, q_p + K−1−j] = h[up·j + r_p]`` — the scattered polyphase bank,
    built once in float64 on host and cast to f32 at the matmul site.
    """
    h = np.asarray(h, dtype=np.float64)
    if len(h) % up != 0:
        h = np.pad(h, (0, up - len(h) % up))
    k = len(h) // up
    r, q = _phase_layout(up, down)
    w = np.zeros((up, down + k - 1), dtype=np.float64)
    j = np.arange(k)
    for p in range(up):
        w[p, q[p] + (k - 1) - j] = h[up * j + r[p]]
    return w


@functools.partial(jax.jit, static_argnames=("up", "down", "k", "return_zf"))
def _resample_impl(x, w, zi, *, up, down, k, return_zf):
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).astype(jnp.float32)
    b = xb.shape[0]
    halo = k - 1
    if zi is None:
        hist = jnp.zeros((b, halo), dtype=jnp.float32)
    else:
        hist = zi.reshape(b, halo).astype(jnp.float32)

    s_groups = -(-t // down)  # ceil: groups of `up` outputs
    k2 = down + k - 1
    # slab[s, τ] = stream[s·down + τ], stream = halo history ++ signal ++ 0s.
    nblk = 1 + -(-halo // down)  # consecutive down-blocks covering k2
    stream_len = (s_groups + nblk - 1) * down
    tail = stream_len - halo - t
    xp = jnp.concatenate(
        [hist, xb, jnp.zeros((b, tail), dtype=jnp.float32)], axis=-1
    )
    # Overlapping slabs from `nblk` shifted block-reshapes (no gather).
    parts = [
        xp[:, e * down : (e + s_groups) * down].reshape(b, s_groups, down)
        for e in range(nblk)
    ]
    slab = jnp.concatenate(parts, axis=-1)[:, :, :k2]  # (B, S, k2)
    from llzlab_tpu.ops.transform import matmul_precision

    y = jnp.einsum(
        "bsk,pk->bsp", slab, w,
        preferred_element_type=jnp.float32,
        precision=matmul_precision(),  # GPU f32 default is 1-pass TF32
    )
    n_out = resample_output_len(t, up, down)
    y = y.reshape(b, s_groups * up)[:, :n_out]
    y = y.reshape(shape[:-1] + (n_out,)).astype(x.dtype)
    if not return_zf:
        return y
    # Final history: last k−1 *input* samples (for T % down == 0 streaming).
    zf = xp[:, t : t + halo].reshape(shape[:-1] + (halo,))
    return y, zf


def resample_poly(
    x: jnp.ndarray,
    up: int,
    down: int,
    *,
    taps=None,
    taps_per_phase: int = 64,
    window=("kaiser", 8.0),
    zi: Optional[jnp.ndarray] = None,
    return_zf: bool = False,
):
    """Rational resampling along the last axis via a dense polyphase matmul.

    Args:
      x: ``(..., T)`` signal.
      up, down: rational rate factors (reduced by their gcd internally).
      taps: optional prototype lowpass (length ``up·K`` after gcd
        reduction); designed via :func:`resample_taps` if omitted.
      taps_per_phase: K, taps per polyphase branch when auto-designing.
      zi: optional ``(..., K−1)`` input history for streaming; zeros if
        omitted.
      return_zf: also return the final input history.

    Returns ``(..., ceil(T·up/down))`` causal outputs, numerically equal to
    ``scipy.signal.upfirdn(taps, x, up, down)[: n_out]``.  Streaming is
    exact when each fed block has ``T % down == 0`` (group phase realigns
    at block boundaries).
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1 and taps is None:
        return (x, jnp.zeros(x.shape[:-1] + (0,), x.dtype)) if return_zf else x
    if taps is None:
        taps = resample_taps(up, down, taps_per_phase, window=window)
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) % up != 0:
        taps = np.pad(taps, (0, up - len(taps) % up))
    k = len(taps) // up
    w = jnp.asarray(polyphase_weights(taps, up, down).astype(np.float32))
    return _resample_impl(
        x, w, zi, up=up, down=down, k=k, return_zf=return_zf
    )
