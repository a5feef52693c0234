"""Fused FIR→polyphase-resample chain as one composite polyphase matmul.

The BASELINE.json:2 headline workload is ``resample_poly(fir_filter(x))``.
Both stages are linear, so their composition is a single block-periodic
linear map: for each output group ``s`` (``up`` outputs), the window of
inputs it depends on is the convolution of the FIR taps with the scattered
polyphase bank row —

    z[s, p] = Σ_i G[p, i] · x[s·down + i − offset],
    G[p]    = conv(W_r[p], reverse(h_fir)),  offset = (K−1) + (ntaps−1),

where ``W_r`` is the dense ``(up, down+K−1)`` group weight matrix of
:func:`llzlab_tpu.ops.resample.polyphase_weights`.  Fusing removes the
intermediate FIR output from device memory entirely (the chain becomes
matrix-product work instead of bouncing a full-rate signal through
memory) and the composite costs barely more FLOPs than the FIR alone
(``up·|G|/down ≈ ntaps`` MACs per input sample).

Evaluated as ``ceil(|G'|/down)`` shifted block matmuls summed — each
operand a zero-copy strided reshape of the padded input, no im2col slab is
ever materialised:

    z = Σ_e  xs[:, e·down : (e+S)·down].reshape(B,S,down) @ G'ᵀ[e·down:…]

Capability parity: composes the reference's ``llz_fir.c`` + ``llz_resample.c``
streaming loops (mount empty — spec anchor BASELINE.json:5,7,8).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops.resample import (
    polyphase_weights,
    resample_output_len,
    resample_taps,
)
from llzlab_tpu.ops.transform import matmul_precision_name, prec_enum
from llzlab_tpu.runtime.platform import backend

__all__ = ["fir_resample", "fir_resample_state_len", "fir_resample_tables",
           "fir_resample_engine"]


@functools.lru_cache(maxsize=16)
def _tables_np(fir_bytes: bytes, r_bytes: bytes, up: int, down: int):
    """float64 composite weight blocks ``(nparts, down, up)`` and the
    history length (input samples)."""
    h_fir = np.frombuffer(fir_bytes, np.float64)
    rtaps = np.frombuffer(r_bytes, np.float64)
    if len(rtaps) % up != 0:
        rtaps = np.pad(rtaps, (0, up - len(rtaps) % up))
    k = len(rtaps) // up
    w_r = polyphase_weights(rtaps, up, down)  # (up, down+k-1) float64
    ntaps = len(h_fir)
    offset = (k - 1) + (ntaps - 1)
    glen = (down + k - 1) + ntaps - 1
    # W_r rows hold the bank time-reversed (newest input at the highest
    # column), so the composite row is conv with the *reversed* FIR taps.
    g = np.stack([np.convolve(w_r[p], h_fir[::-1]) for p in range(up)])
    hist_parts = -(-offset // down)
    pad_front = hist_parts * down - offset
    gp = np.pad(g, ((0, 0), (pad_front, 0)))
    nparts = -(-gp.shape[1] // down)
    gp = np.pad(gp, ((0, 0), (0, nparts * down - gp.shape[1])))
    assert glen == g.shape[1]
    # part e multiplies input block s+e
    return gp.reshape(up, nparts, down).transpose(1, 2, 0), hist_parts * down


@functools.lru_cache(maxsize=16)
def _tables_cached(fir_bytes: bytes, r_bytes: bytes, up: int, down: int):
    gparts, hist_len = _tables_np(fir_bytes, r_bytes, up, down)
    with jax.ensure_compile_time_eval():
        return jnp.asarray(gparts.astype(np.float32)), hist_len


@functools.lru_cache(maxsize=16)
def _pallas_tables(fir_bytes: bytes, r_bytes: bytes, up: int, down: int,
                   mode: str):
    from llzlab_tpu.kernels.fused_fir_resample import kernel_tables

    gparts, hist_len = _tables_np(fir_bytes, r_bytes, up, down)
    return kernel_tables(gparts, mode), hist_len


def _table_key(fir_taps, up: int, down: int, rtaps):
    g = math.gcd(up, down)
    return (np.asarray(fir_taps, np.float64).tobytes(),
            np.asarray(rtaps, np.float64).tobytes(), up // g, down // g)


def fir_resample_tables(fir_taps, up: int, down: int, rtaps):
    """Composite weight blocks ``(nparts, down, up)`` and history length."""
    return _tables_cached(*_table_key(fir_taps, up, down, rtaps))


def fir_resample_state_len(fir_taps_len: int, up: int, down: int,
                           rtaps_len: int) -> int:
    """Streaming history length (input samples) for :func:`fir_resample`
    (the same for every engine)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    k = -(-rtaps_len // up)
    offset = (k - 1) + (fir_taps_len - 1)
    return -(-offset // down) * down


def fir_resample_engine() -> str:
    """Resolve the "auto" engine choice for :func:`fir_resample`: the
    Pallas kernel on the GPU (faster than the composite at both tiers,
    PERF.md), the XLA composite on the CPU."""
    return {"gpu": "pallas", "cpu": "composite"}[backend()]


@functools.partial(jax.jit, static_argnames=("up", "down", "hist_len",
                                             "return_zf", "prec"))
def _fir_resample_impl(x, gparts, zi, *, up, down, hist_len, return_zf,
                       prec="highest"):
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).astype(jnp.float32)
    b = xb.shape[0]
    if zi is None:
        hist = jnp.zeros((b, hist_len), jnp.float32)
    else:
        hist = zi.reshape(b, hist_len).astype(jnp.float32)
    s_groups = -(-t // down)
    nparts = gparts.shape[0]
    stream_len = (s_groups + nparts - 1) * down
    tail = stream_len - hist_len - t
    xs = jnp.concatenate(
        [hist, xb, jnp.zeros((b, max(tail, 0)), jnp.float32)], axis=-1
    )
    if tail < 0:
        xs = xs[:, :stream_len]
    kw = dict(preferred_element_type=jnp.float32, precision=prec_enum(prec))
    z = None
    for e in range(nparts):
        part = xs[:, e * down : (e + s_groups) * down].reshape(
            b, s_groups, down
        )
        term = jnp.einsum("bsd,dp->bsp", part, gparts[e], **kw)
        z = term if z is None else z + term
    n_out = resample_output_len(t, up, down)
    z = z.reshape(b, s_groups * up)[:, :n_out]
    z = z.reshape(shape[:-1] + (n_out,)).astype(x.dtype)
    if not return_zf:
        return z
    # Final history: the last hist_len *input* samples of (hist ++ signal).
    zf = jnp.concatenate([hist, xb], axis=-1)[:, -hist_len:]
    zf = zf.astype(x.dtype).reshape(shape[:-1] + (hist_len,))
    return z, zf


def fir_resample(
    x: jnp.ndarray,
    fir_taps,
    up: int,
    down: int,
    *,
    rtaps=None,
    taps_per_phase: int = 64,
    zi: Optional[jnp.ndarray] = None,
    return_zf: bool = False,
    engine: str = "auto",
    precision: Optional[str] = None,
):
    """FIR filter + rational resample as one composite linear map.

    Numerically equal (same linear map, matmul-reassociated) to

        y = fir_filter(x, fir_taps);  z = resample_poly(y, up, down, rtaps)

    Args:
      x: ``(..., T)`` signal.
      fir_taps: ``(ntaps,)`` host-concrete FIR taps.
      up, down: rational rate factors (reduced by gcd internally).
      rtaps: optional resampler prototype (designed if omitted).
      zi: optional ``(..., fir_resample_state_len(...))`` input history.
      return_zf: also return the final history for streaming continuation.
      engine: "auto" | "pallas" | "composite".  "pallas" is the fused
        kernel (kernels/fused_fir_resample.py, GPU; Pallas interpreter on
        the CPU), "composite" the XLA shifted-matmul form.  Both take the
        same weights and history, so their states interchange.  "auto"
        resolves via :func:`fir_resample_engine`.
      precision: "highest" | "high" | "default"; default from
        :func:`llzlab_tpu.ops.transform.matmul_precision_name`.

    Streaming is exact when each fed block has ``T % down == 0``.
    """
    g = math.gcd(up, down)
    up_r, down_r = up // g, down // g
    if rtaps is None:
        rtaps = resample_taps(up_r, down_r, taps_per_phase)
    if engine == "auto":
        engine = fir_resample_engine()
    prec = (precision or matmul_precision_name()).lower()
    if engine == "pallas":
        from llzlab_tpu.kernels.fused_fir_resample import (
            fused_fir_resample_pallas,
        )

        tables, hist_len = _pallas_tables(
            *_table_key(fir_taps, up, down, rtaps),
            "highest" if prec == "highest" else "high")
        return fused_fir_resample_pallas(
            x, tables, hist_len, up_r, down_r, zi=zi, return_zf=return_zf,
            interpret=backend() == "cpu",
        )
    if engine != "composite":
        raise ValueError(f"unknown engine {engine!r}")
    gparts, hist_len = fir_resample_tables(fir_taps, up_r, down_r, rtaps)
    return _fir_resample_impl(
        x, gparts, zi, up=up_r, down=down_r, hist_len=hist_len,
        return_zf=return_zf, prec=prec,
    )
