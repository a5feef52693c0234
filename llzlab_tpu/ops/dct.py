"""DCT / DST (types I–IV) along the last axis.

Capability companion to the MDCT (SURVEY.md §2b row 14): codec and
spectral-analysis pipelines need plain block cosine/sine transforms too.

Design: like ops/mdct.py, each transform is a dense ``(N, N)`` matrix
built once on host in float64 and applied as one batched matmul at
f32/HIGHEST — for the codec-scale N (≤ 4096) used in DSP chains a
matrix unit runs this faster than a radix factorisation, exact to
f32 rounding.  Matches ``scipy.fft.dct/dst`` conventions (types 1–4,
``norm=None | "ortho"``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops.transform import matmul_precision as _matmul_precision

__all__ = ["dct", "idct", "dst", "idst", "dct_matrix", "dst_matrix"]


@functools.lru_cache(maxsize=64)
def dct_matrix(n: int, dct_type: int = 2, norm=None) -> np.ndarray:
    """Dense float64 DCT matrix ``M`` with ``X = M @ x``."""
    k = np.arange(n, dtype=np.float64)[:, None]  # output index
    m = np.arange(n, dtype=np.float64)[None, :]  # input index
    if dct_type == 1:
        if n < 2:
            raise ValueError("DCT-I needs n ≥ 2")
        M = 2.0 * np.cos(np.pi * k * m / (n - 1))
        M[:, 0] = 1.0
        M[:, -1] = np.cos(np.pi * k[:, 0])
        if norm == "ortho":
            M[:, 0] *= np.sqrt(2.0)
            M[:, -1] *= np.sqrt(2.0)
            M[0, :] /= np.sqrt(2.0)
            M[-1, :] /= np.sqrt(2.0)
            M *= np.sqrt(1.0 / (2.0 * (n - 1)))
    elif dct_type == 2:
        M = 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[0, :] /= np.sqrt(2.0)
    elif dct_type == 3:
        M = 2.0 * np.cos(np.pi * (2.0 * k + 1.0) * m / (2.0 * n))
        M[:, 0] = 1.0
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[:, 0] *= np.sqrt(2.0)
    elif dct_type == 4:
        M = 2.0 * np.cos(np.pi * (2.0 * k + 1.0) * (2.0 * m + 1.0) / (4.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
    else:
        raise ValueError(f"unknown DCT type {dct_type}")
    return M


@functools.lru_cache(maxsize=64)
def dst_matrix(n: int, dst_type: int = 2, norm=None) -> np.ndarray:
    """Dense float64 DST matrix ``M`` with ``X = M @ x``."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    if dst_type == 1:
        M = 2.0 * np.sin(np.pi * (k + 1.0) * (m + 1.0) / (n + 1.0))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * (n + 1.0)))
    elif dst_type == 2:
        M = 2.0 * np.sin(np.pi * (k + 1.0) * (2.0 * m + 1.0) / (2.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[-1, :] /= np.sqrt(2.0)
    elif dst_type == 3:
        M = 2.0 * np.sin(np.pi * (2.0 * k + 1.0) * (m + 1.0) / (2.0 * n))
        M[:, -1] = np.sin(np.pi * (2.0 * k[:, 0] + 1.0) / 2.0)
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[:, -1] *= np.sqrt(2.0)
    elif dst_type == 4:
        M = 2.0 * np.sin(np.pi * (2.0 * k + 1.0) * (2.0 * m + 1.0) / (4.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
    else:
        raise ValueError(f"unknown DST type {dst_type}")
    return M


def _apply(x: jnp.ndarray, M: np.ndarray) -> jnp.ndarray:
    Mj = jnp.asarray(M.astype(np.float32))
    return jnp.einsum(
        "...n,kn->...k", x.astype(jnp.float32), Mj,
        preferred_element_type=jnp.float32,
        precision=_matmul_precision(),
    ).astype(x.dtype)


@functools.partial(jax.jit, static_argnames=("type", "norm"))
def dct(x: jnp.ndarray, type: int = 2, norm=None) -> jnp.ndarray:
    """Discrete cosine transform along the last axis (scipy.fft.dct)."""
    return _apply(x, dct_matrix(x.shape[-1], type, norm))


@functools.partial(jax.jit, static_argnames=("type", "norm"))
def idct(x: jnp.ndarray, type: int = 2, norm=None) -> jnp.ndarray:
    """Inverse DCT (scipy.fft.idct): the inverse of :func:`dct` with the
    same ``type``/``norm`` arguments."""
    n = x.shape[-1]
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    M = dct_matrix(n, inv_type, norm)
    if norm != "ortho":
        scale = {1: 2.0 * (n - 1) if n > 1 else 1.0, 2: 2.0 * n,
                 3: 2.0 * n, 4: 2.0 * n}[type]
        M = M / scale
    return _apply(x, M)


@functools.partial(jax.jit, static_argnames=("type", "norm"))
def dst(x: jnp.ndarray, type: int = 2, norm=None) -> jnp.ndarray:
    """Discrete sine transform along the last axis (scipy.fft.dst)."""
    return _apply(x, dst_matrix(x.shape[-1], type, norm))


@functools.partial(jax.jit, static_argnames=("type", "norm"))
def idst(x: jnp.ndarray, type: int = 2, norm=None) -> jnp.ndarray:
    """Inverse DST (scipy.fft.idst)."""
    n = x.shape[-1]
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    M = dst_matrix(n, inv_type, norm)
    if norm != "ortho":
        scale = {1: 2.0 * (n + 1), 2: 2.0 * n, 3: 2.0 * n, 4: 2.0 * n}[type]
        M = M / scale
    return _apply(x, M)
