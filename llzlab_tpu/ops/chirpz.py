"""Chirp-Z transform, zoom FFT, and Fourier-method resampling.

Reference counterpart: none upstream (the C lab's spectral zoom was done
by hand with FFT + decimation); these complete the transform family
(SURVEY.md §2a row 1) with scipy.signal.czt / ZoomFFT / resample
semantics:

* CZT uses Bluestein's factorisation  X_k = w^{k²/2} · IFFT(FFT(x·A) ⊙
  FFT(chirp))  — two batched FFTs, chirp
  tables built once on host in float64;
* Fourier resampling is rfft → band trim/pad → irfft, matching
  ``scipy.signal.resample`` including the even-bin halving convention.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["czt", "zoom_fft", "resample_fourier"]


@functools.lru_cache(maxsize=32)
def _czt_tables(n: int, m: int, w: complex, a: complex, nfft: int):
    """Host f64 chirp tables: (A_n · w^{n²/2}, FFT(w^{-k²/2}), w^{k²/2})."""
    k = np.arange(max(n, m), dtype=np.float64)
    wexp = np.exp(np.log(complex(w)) * (k**2) / 2.0)  # w^{k²/2}
    an = np.power(complex(a), -k[:n]) * wexp[:n]
    # Bluestein kernel: v[j] = w^{-j²/2} for j in (-(n-1) … m-1), wrapped.
    j = np.arange(-(n - 1), m, dtype=np.float64)
    v = np.exp(-np.log(complex(w)) * (j**2) / 2.0)
    vpad = np.zeros(nfft, np.complex128)
    vpad[: 2 * max(n, m) - 1][: len(v)] = v
    # circular layout: index of j=0 is n-1; roll so output k sits at bin k
    vpad = np.roll(vpad, -(n - 1))
    V = np.fft.fft(vpad)
    with jax.ensure_compile_time_eval():
        return (
            jnp.asarray(an.astype(np.complex64)),
            jnp.asarray(V.astype(np.complex64)),
            jnp.asarray(wexp[:m].astype(np.complex64)),
        )


@functools.partial(jax.jit, static_argnames=("n", "m", "nfft"))
def _czt_impl(x, an, V, wm, *, n: int, m: int, nfft: int):
    from llzlab_tpu.ops import transform as _tf

    xa = x[..., :n].astype(jnp.complex64) * an
    X = _tf.fft(xa, nfft)
    y = _tf.ifft(X * V, nfft)
    return y[..., :m] * wm


def czt(
    x: jnp.ndarray,
    m: Optional[int] = None,
    w: Optional[complex] = None,
    a: complex = 1.0 + 0.0j,
) -> jnp.ndarray:
    """Chirp-Z transform along the last axis (scipy.signal.czt semantics).

    Evaluates ``X_k = Σ_n x[n] · (a · w^{-k})^{-n}``, k = 0…m−1 — the
    z-transform on a logarithmic spiral.  Defaults (m = len(x),
    w = exp(−2πi/m)) reduce to the DFT.  Device op via Bluestein.
    """
    n = x.shape[-1]
    m = m or n
    if w is None:
        w = np.exp(-2j * np.pi / m)
    nfft = 1 << max(4, int(np.ceil(np.log2(n + m - 1))))
    an, V, wm = _czt_tables(n, m, complex(w), complex(a), nfft)
    return _czt_impl(x, an, V, wm, n=n, m=m, nfft=nfft)


def zoom_fft(
    x: jnp.ndarray,
    fn,
    m: Optional[int] = None,
    *,
    fs: float = 2.0,
    endpoint: bool = False,
) -> jnp.ndarray:
    """Zoomed DFT over the band ``fn = [f1, f2]`` (scipy.signal.zoom_fft).

    Returns ``m`` spectral samples over [f1, f2] (excluding f2 unless
    ``endpoint``) — the DSP "spectral magnifier": fine resolution over a
    narrow band without a huge FFT.
    """
    n = x.shape[-1]
    m = m or n
    try:
        f1, f2 = (float(fn[0]), float(fn[1]))
    except TypeError:
        f1, f2 = 0.0, float(fn)
    if endpoint and m > 1:
        step = (f2 - f1) / (fs * (m - 1))
    else:
        step = (f2 - f1) / (fs * m)
    w = np.exp(-2j * np.pi * step)
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m=m, w=w, a=a)


def resample_fourier(x: jnp.ndarray, num: int) -> jnp.ndarray:
    """Alias for :func:`llzlab_tpu.ops.resample.resample` (FFT method,
    no spectral window) kept for the zoom-FFT/czt family's namespace."""
    from llzlab_tpu.ops.resample import resample

    if num == x.shape[-1]:
        return x
    return resample(x, num)
