"""Smoothing / denoising ops: Savitzky-Golay, median, Wiener, detrend.

Reference counterpart: none in the upstream C lab (SURVEY.md §2 covers
rows 1-15); these extend the framework's analysis surface with the
scipy.signal smoothing family:

* windows are materialised as ``k`` shifted zero-copy slices (never a
  gather), so sliding statistics (median, local mean/var) vectorise
  and polynomial smoothing lowers to one FIR pass;
* all ops are jit-able, batched over leading axes.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "detrend",
    "savgol_coeffs",
    "savgol_filter",
    "medfilt",
    "wiener",
]


@functools.partial(jax.jit, static_argnames=("type",))
def detrend(x: jnp.ndarray, *, type: str = "linear") -> jnp.ndarray:
    """Remove a constant or least-squares linear trend along the last axis.

    Matches ``scipy.signal.detrend`` for ``type`` in {"constant",
    "linear"}; batched over leading axes, f32 device op.
    """
    x = x.astype(jnp.float32)
    if type == "constant":
        return x - jnp.mean(x, axis=-1, keepdims=True)
    if type != "linear":
        raise ValueError("type must be 'linear' or 'constant'")
    t = x.shape[-1]
    # Closed-form LSQ line fit on the centred index (well-conditioned).
    n = jnp.arange(t, dtype=jnp.float32) - (t - 1) / 2.0
    denom = jnp.sum(n * n)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    slope = jnp.sum(x * n, axis=-1, keepdims=True) / denom
    return x - mean - slope * n


def savgol_coeffs(
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
    pos: Optional[float] = None,
) -> np.ndarray:
    """Savitzky-Golay FIR coefficients (scipy semantics, host-side f64).

    The returned taps convolve (scipy convention: ``c[::-1]`` correlates)
    to evaluate the ``deriv``-th derivative of the local least-squares
    polynomial fit of order ``polyorder`` at position ``pos`` (window
    centre by default).
    """
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        if rem == 0:
            pos = halflen - 0.5
        else:
            pos = halflen
    if not (0 <= pos < window_length):
        raise ValueError("pos must be nonnegative and less than window_length")
    if deriv > polyorder:
        return np.zeros(window_length, np.float64)
    import math as _math

    # Solve A c = e_deriv·deriv!/δ^deriv via lstsq on the Vandermonde system.
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    x = x[::-1]  # convolution (not correlation) orientation, as scipy
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x**order
    y = np.zeros(polyorder + 1, np.float64)
    y[deriv] = _math.factorial(deriv) / (delta**deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


@functools.partial(jax.jit, static_argnames=("mode",))
def _savgol_apply(x, taps, *, mode: str):
    from llzlab_tpu.ops.convolve import fftconvolve

    t = x.shape[-1]
    k = taps.shape[-1]
    half = k // 2
    if mode == "constant":
        xe = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
    elif mode == "nearest":
        xe = jnp.pad(
            x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="edge"
        )
    elif mode == "mirror":
        xe = jnp.pad(
            x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="reflect"
        )
    elif mode == "wrap":
        xe = jnp.pad(
            x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="wrap"
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = fftconvolve(xe, taps, mode="valid")
    return y[..., :t]


def savgol_filter(
    x: jnp.ndarray,
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
    mode: str = "interp",
) -> jnp.ndarray:
    """Savitzky-Golay smoothing along the last axis (scipy semantics).

    ``mode="interp"`` (default, as scipy) fits a polynomial to the first
    and last ``window_length`` samples for the edges; other modes pad.
    Device op: the interior is one FFT convolution (matmul path).
    """
    x = jnp.asarray(x, jnp.float32)
    taps = savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    tapsj = jnp.asarray(taps.astype(np.float32))
    if mode != "interp":
        return _savgol_apply(x, tapsj, mode=mode)
    t = x.shape[-1]
    if window_length > t:
        raise ValueError("window_length exceeds signal length for interp")
    y = _savgol_apply(x, tapsj, mode="constant")
    half = window_length // 2
    # Edge replacement: polynomial LSQ fit of the first/last window,
    # evaluated (with the deriv scaling) at the edge sample positions.
    n = np.arange(window_length, dtype=np.float64)
    order = np.arange(polyorder + 1)
    A = n[:, None] ** order[None, :]
    pinv = np.linalg.pinv(A)  # (polyorder+1, window)

    # Evaluation matrix for derivative `deriv` at positions 0..half-1.
    def eval_matrix(pos):
        e = np.zeros((len(pos), polyorder + 1), np.float64)
        for d_i, p in enumerate(order):
            if p >= deriv:
                coef = 1.0
                for q in range(deriv):
                    coef *= p - q
                e[:, d_i] = coef * pos ** (p - deriv)
        return e * (1.0 / delta**deriv)

    pos_head = np.arange(half, dtype=np.float64)
    pos_tail = np.arange(t - half, t, dtype=np.float64) - (t - window_length)
    Eh = jnp.asarray((eval_matrix(pos_head) @ pinv).astype(np.float32))
    Et = jnp.asarray((eval_matrix(pos_tail) @ pinv).astype(np.float32))
    head = jnp.einsum("pw,...w->...p", Eh, x[..., :window_length])
    tail = jnp.einsum("pw,...w->...p", Et, x[..., -window_length:])
    return jnp.concatenate([head, y[..., half : t - half], tail], axis=-1)


@functools.partial(jax.jit, static_argnames=("kernel_size",))
def medfilt(x: jnp.ndarray, kernel_size: int = 3) -> jnp.ndarray:
    """Sliding median along the last axis (scipy.signal.medfilt semantics:
    odd ``kernel_size``, zero padding at the edges).

    The window is ``kernel_size`` shifted zero-copy slices stacked on a
    new axis and sorted — no gathers, no loops.
    """
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    half = kernel_size // 2
    x = x.astype(jnp.float32)
    xe = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
    t = x.shape[-1]
    win = jnp.stack([xe[..., s : s + t] for s in range(kernel_size)], axis=-1)
    return jnp.sort(win, axis=-1)[..., half]


@functools.partial(jax.jit, static_argnames=("mysize",))
def _wiener_impl(x, mysize: int, noise):
    half = mysize // 2
    xe = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
    t = x.shape[-1]

    def local_sum(v):
        acc = v[..., 0:t]
        for s in range(1, mysize):
            acc = acc + v[..., s : s + t]
        return acc

    lmean = local_sum(xe) / mysize
    lvar = local_sum(xe * xe) / mysize - lmean * lmean
    if noise is None:
        noise = jnp.mean(lvar, axis=-1, keepdims=True)
    res = x - lmean
    gain = jnp.maximum(lvar - noise, 0.0) / jnp.maximum(lvar, noise)
    out = lmean + gain * res
    return jnp.where(lvar < noise, lmean, out)


def wiener(
    x: jnp.ndarray, mysize: int = 3, noise: Optional[float] = None
) -> jnp.ndarray:
    """Local-statistics Wiener denoiser (scipy.signal.wiener, 1-D).

    ``noise=None`` estimates the noise power as the mean local variance
    (scipy's default).  Device op; local moments are shifted-slice sums.
    """
    x = jnp.asarray(x, jnp.float32)
    n = None if noise is None else jnp.float32(noise)
    return _wiener_impl(x, mysize, n)
