"""MDCT / IMDCT — lapped transform with TDAC perfect reconstruction.

Capability parity target: the reference's ``llz_mdct.c/h`` (MDCT via FFT
for codec windowing; mount empty — SURVEY.md §2b row 14).

Design: for codec-scale frames (N ≤ 4096) the MDCT is a dense
``(N, 2N)`` cosine matrix applied to 50 %-overlapped windowed frames —
one batched matmul at f32/HIGHEST, no twiddle bookkeeping, exactly
the philosophy of the matmul FFT (ops/transform.py).  The matrix is
built once on host in float64.

    X[k] = Σ_{n=0}^{2N−1} w[n]·x[n]·cos(π/N·(n + ½ + N/2)·(k + ½))

IMDCT applies the transpose (scaled 2/N), windows again, and overlap-adds
with hop N; the Princen–Bradley condition (sine or KBD window) gives
perfect reconstruction in the interior.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops import spectral as _sp

__all__ = ["mdct", "imdct", "sine_window", "mdct_matrix"]


def sine_window(n2: int) -> np.ndarray:
    """Princen–Bradley sine window of length 2N (MP3/AAC style)."""
    k = np.arange(n2, dtype=np.float64)
    return np.sin(np.pi / n2 * (k + 0.5))


@functools.lru_cache(maxsize=16)
def mdct_matrix(n: int) -> np.ndarray:
    """The (N, 2N) float64 MDCT cosine matrix."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(2 * n, dtype=np.float64)[None, :]
    return np.cos(np.pi / n * (m + 0.5 + n / 2.0) * (k + 0.5))


def _resolve_window(window, n2: int) -> np.ndarray:
    if window is None or window == "sine":
        return sine_window(n2)
    from llzlab_tpu.ops.window import get_window

    return get_window(window, n2, periodic=True)


@functools.partial(jax.jit, static_argnames=("n", "window"))
def _mdct_impl(x, *, n, window):
    w = jnp.asarray(_resolve_window(window, 2 * n).astype(np.float32))
    M = jnp.asarray(mdct_matrix(n).astype(np.float32))
    frames = _sp.frame(x.astype(jnp.float32), 2 * n, n) * w  # (..., F, 2N)
    return jnp.einsum(
        "...fm,km->...fk", frames, M,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def mdct(x: jnp.ndarray, n: int = 1024, *, window="sine") -> jnp.ndarray:
    """MDCT along the last axis: ``(..., T)`` → ``(..., F, N)`` with 50 %
    overlap (hop = N).  ``F = T/N − 1`` frames for T a multiple of N."""
    if x.shape[-1] % n:
        raise ValueError(f"T={x.shape[-1]} must be a multiple of N={n}")
    return _mdct_impl(x, n=n, window=window)


@functools.partial(jax.jit, static_argnames=("n", "window", "length"))
def _imdct_impl(spec, *, n, window, length):
    w = jnp.asarray(_resolve_window(window, 2 * n).astype(np.float32))
    M = jnp.asarray(mdct_matrix(n).astype(np.float32))
    frames = (2.0 / n) * jnp.einsum(
        "...fk,km->...fm", spec, M,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = _sp.overlap_add(frames * w, n)
    if length is not None:
        y = y[..., :length]
    return y


def imdct(
    spec: jnp.ndarray, *, window="sine", length: Optional[int] = None
) -> jnp.ndarray:
    """Inverse MDCT with windowed TDAC overlap-add.

    ``imdct(mdct(x))`` reconstructs ``x`` exactly (time-domain alias
    cancellation) away from the first and last N samples.
    """
    n = spec.shape[-1]
    return _imdct_impl(spec, n=n, window=window, length=length)
