"""Generic fast convolution / correlation (FFT overlap method).

Core lab utility (the reference's fast-conv machinery generalised beyond
the streaming FIR path): full/same/valid 1-D convolution of arbitrary
pairs via the FFT, batched over leading dims.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops import transform as _tf

__all__ = ["fftconvolve", "correlate"]


def _next_pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


@functools.partial(jax.jit, static_argnames=("mode", "nfull"))
def _conv_impl(a, b, *, mode: str, nfull: int):
    nfft = _next_pow2(nfull)
    A = _tf.rfft(a, nfft)
    B = _tf.rfft(b, nfft)
    y = _tf.irfft(A * B, nfft)[..., :nfull]
    na, nb = a.shape[-1], b.shape[-1]
    if mode == "full":
        return y
    if mode == "same":
        start = (min(na, nb) - 1) // 2
        return y[..., start : start + max(na, nb)]
    # valid
    nv = max(na, nb) - min(na, nb) + 1
    start = min(na, nb) - 1
    return y[..., start : start + nv]


def fftconvolve(a: jnp.ndarray, b: jnp.ndarray, mode: str = "full"):
    """FFT convolution along the last axis (leading dims broadcast).

    Matches ``numpy.convolve``/``scipy.signal.fftconvolve`` semantics for
    ``mode`` in {"full", "same", "valid"}.
    """
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode {mode!r}")
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    nfull = a.shape[-1] + b.shape[-1] - 1
    return _conv_impl(a, b, mode=mode, nfull=nfull)


def correlate(a: jnp.ndarray, b: jnp.ndarray, mode: str = "full"):
    """Cross-correlation ``Σ a[n+k]·b[n]`` via convolution with the
    reversed second argument."""
    b = jnp.asarray(b, jnp.float32)
    return fftconvolve(a, b[..., ::-1], mode=mode)
