"""Fused matmul overlap-save: FIR filtering as one spectral linear map.

Capability parity target: the fast-convolution path of the reference's
``llz_fir.c`` (overlap-save via FFT; mount empty — spec anchor
BASELINE.json:5 "FIR convolution via overlap-save ... HBM-bandwidth-bound
for long filters, MXU-bound for block convolution").

Why this exists (SURVEY.md §7 hard part 2 / STATUS gap 2): the generic
``rfft → ⊙H → irfft`` path spends most of its HBM traffic on the
real-FFT untangling (conjugate-mirror permutations lower to gathers) and
on batched 64×32 matmuls in (z, n1, n2) layout that underfill the matrix unit and
force (z,c,b) relayouts.  For overlap-save the filter taps are *fixed*,
so the whole middle of the pipeline collapses algebraically:

  1. Pack each real frame of ``nfft`` samples as ``half = nfft/2``
     complex values ``z[m] = x[2m] + j·x[2m+1]`` — but split even/odd on
     the *signal* once, then frame, so framing runs at half length.
  2. Forward four-step DFT of size ``half`` in transposed layout:
     ``(c, z·b)``-shaped matmuls (contraction over the DFT axis with
     the huge batch·frame dimension in lanes), twiddle, second matmul.
     The output stays in scrambled (c, d) order — never descrambled.
  3. The entire real-FFT untangle → ×H(k) → re-entangle for the inverse
     is one per-bin linear map  ``Z'[k] = A[k]·Z[k] + B[k]·conj(Z[σk])``
     with ``σk = (half − k) mod half`` — A/B are host-precomputed (f64)
     from the taps by probing the exact scipy/numpy pipeline and solving
     a 2×2 system per bin (no hand algebra to get wrong).  σ is a
     flip+roll, expressed as slices+reverses in (c, d) coordinates.
  4. Inverse four-step with conjugate tables (1/half folded into A/B),
     still in transposed layout; unpack even/odd on the signal at the
     end.  The wrap-around discard is a slice in the packed domain.

Everything between HBM reads of the framed signal and HBM writes of the
valid samples is dense f32 matmuls + fused elementwise — no gathers,
no per-frame small matmuls.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops.transform import (
    matmul_precision,
    split_factors,
)

__all__ = ["ols_tables", "ols_filter_matmul"]


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------


def _combine_coeffs(taps: np.ndarray, nfft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bin (A, B) with Z' = A·Z + B·conj(Z[σ]) for the packed pipeline.

    Probes the exact f64 reference map (ifft → interleave → rfft·H·irfft →
    deinterleave → fft) with random vectors and solves the 2×2 system per
    bin; a third probe verifies the linear form to ~1e-10.
    """
    half = nfft // 2
    H = np.fft.rfft(np.asarray(taps, np.float64), nfft)

    def roundtrip(Z):
        zt = np.fft.ifft(Z)
        x = np.empty(nfft, np.float64)
        x[0::2] = zt.real
        x[1::2] = zt.imag
        y = np.fft.irfft(np.fft.rfft(x) * H, nfft)
        return np.fft.fft(y[0::2] + 1j * y[1::2])

    sigma = (half - np.arange(half)) % half
    rng = np.random.default_rng(12345)
    for attempt in range(4):
        Z1 = rng.standard_normal(half) + 1j * rng.standard_normal(half)
        Z2 = rng.standard_normal(half) + 1j * rng.standard_normal(half)
        P1, P2 = roundtrip(Z1), roundtrip(Z2)
        c1, c2 = np.conj(Z1[sigma]), np.conj(Z2[sigma])
        det = Z1 * c2 - Z2 * c1
        if np.min(np.abs(det)) < 1e-9:
            continue
        A = (P1 * c2 - P2 * c1) / det
        B = (Z1 * P2 - Z2 * P1) / det
        Z3 = rng.standard_normal(half) + 1j * rng.standard_normal(half)
        resid = roundtrip(Z3) - (A * Z3 + B * np.conj(Z3[sigma]))
        scale = np.sqrt(np.mean(np.abs(roundtrip(Z3)) ** 2)) + 1e-30
        if np.sqrt(np.mean(np.abs(resid) ** 2)) / scale < 1e-9:
            return A, B
    raise RuntimeError("OLS combine-coefficient probe failed to converge")


@functools.lru_cache(maxsize=16)
def _ols_tables_cached(taps_bytes: bytes, ntaps: int, nfft: int):
    taps = np.frombuffer(taps_bytes, np.float64)
    half = nfft // 2
    n1, n2 = split_factors(half)

    # Forward DFT tables for size `half` (f64 → f32 once).
    a = np.arange(n1)
    F1 = np.exp(-2j * np.pi * np.outer(a, a) / n1)  # F1[c, a]
    d = np.arange(n2)
    F2 = np.exp(-2j * np.pi * np.outer(d, d) / n2)  # F2[b, d]
    Tw = np.exp(-2j * np.pi * np.outer(a, d) / half)  # Tw[c, b]

    # Combine tables in scrambled (c, d) layout: k = n1·d + c, folded 1/half
    # (the inverse stages below use pure conjugate matrices).
    A, B = _combine_coeffs(taps, nfft)
    k = n1 * d[None, :] + a[:, None]  # (c, d) -> bin index
    Acd = (A / half)[k]
    Bcd = (B / half)[k]

    def f32(m):
        # One-time device_put so repeated calls pass cached device arrays
        # (no per-call host→device table upload).
        # ensure_compile_time_eval: this may run under a user jit trace —
        # the cached arrays must be concrete, never trace-local tracers.
        return (
            jnp.asarray(np.ascontiguousarray(m.real, np.float32)),
            jnp.asarray(np.ascontiguousarray(m.imag, np.float32)),
        )

    with jax.ensure_compile_time_eval():
        return {
            "F1": f32(F1),
            "F2": f32(F2),
            "Tw": f32(Tw),
            "A": f32(Acd),
            "B": f32(Bcd),
        }


def ols_tables(taps, nfft: int):
    """Precompute all device tables for :func:`ols_filter_matmul`.

    ``taps``: host-resolvable 1-D filter taps (len ≤ nfft/2 so the
    overlap-save discard region covers the filter memory).
    """
    taps = np.asarray(jax.device_get(taps), np.float64)
    return _ols_tables_cached(taps.tobytes(), len(taps), int(nfft))


# ---------------------------------------------------------------------------
# Device-side fused pipeline
# ---------------------------------------------------------------------------


def _frame_half(x: jnp.ndarray, flen: int, hop: int, nframes: int) -> jnp.ndarray:
    """(B, Th) → (B, nframes, flen) overlapping frames via shifted reshapes."""
    b = x.shape[0]
    nblk = -(-flen // hop)
    need = (nframes - 1 + nblk) * hop
    if x.shape[1] < need:
        x = jnp.pad(x, ((0, 0), (0, need - x.shape[1])))
    parts = [
        x[:, e * hop : (e + nframes) * hop].reshape(b, nframes, hop)
        for e in range(nblk)
    ]
    return jnp.concatenate(parts, axis=-1)[:, :, :flen]


def _sigma_cd(zr: jnp.ndarray, zi: jnp.ndarray, c_axis: int = 0):
    """conj(Z[σk]); σk = (half−k) mod half, k = n1·d+c; d is the last axis.

    In (c, d) coordinates: row c=0 maps d→(n2−d) mod n2; rows c≥1 map
    (c, d)→(n1−c, n2−1−d).  Pure slices + reverses — no gather.
    ``c_axis`` selects the axis holding c (0 for (c, z, d) layout,
    1 for (z, c, d) layout).
    """

    def perm(t):
        r0 = jax.lax.slice_in_dim(t, 0, 1, axis=c_axis)
        r0f = jnp.concatenate(
            [r0[..., :1], jnp.flip(r0[..., 1:], -1)], -1
        )
        rest = jax.lax.slice_in_dim(t, 1, t.shape[c_axis], axis=c_axis)
        rf = jnp.flip(jnp.flip(rest, c_axis), -1)
        return jnp.concatenate([r0f, rf], c_axis)

    return perm(zr), -perm(zi)


def _matmul_kw():
    return dict(
        preferred_element_type=jnp.float32, precision=matmul_precision()
    )


def _ols_core(xe, xo, tb, orientation: str = "batch"):
    """Packed frames (z, n1, n2) even/odd → filtered packed frames.

    xe/xo: (z, n1, n2) real arrays holding z[m] = x[2m] + j·x[2m+1]
    reshaped with the packed time index m = n2·a + b.
    Returns (ye, yo) in the same layout.

    ``orientation`` picks the einsum layout family:
      * "batch": z stays the leading batch axis throughout — the layout
        with no relayout copies between the matmuls.
      * "transposed": spectra travel as (c, z, d) with the DFT axis
        leading — big single matmuls on paper, but XLA inserts costly
        relayout copies around every convolution.
    """
    F1r, F1i = (jnp.asarray(t) for t in tb["F1"])
    F2r, F2i = (jnp.asarray(t) for t in tb["F2"])
    Twr, Twi = (jnp.asarray(t) for t in tb["Tw"])
    Ar, Ai = (jnp.asarray(t) for t in tb["A"])
    Br, Bi = (jnp.asarray(t) for t in tb["B"])
    kw = _matmul_kw()

    def cmm(eq, ar, ai, br, bi):
        rr = jnp.einsum(eq, ar, br, **kw)
        ii = jnp.einsum(eq, ai, bi, **kw)
        ri = jnp.einsum(eq, ar, bi, **kw)
        ir = jnp.einsum(eq, ai, br, **kw)
        return rr - ii, ri + ir

    if orientation == "transposed":
        # Forward stage 1: Y[c, z, b] = Σ_a F1[c, a] · M[z, a, b]
        yr, yi = cmm("ca,zab->czb", F1r, F1i, xe, xo)
        tr, ti = Twr[:, None, :], Twi[:, None, :]
        zr = yr * tr - yi * ti
        zi = yr * ti + yi * tr
        # Forward stage 2: X2[c, z, d] = Σ_b Z[c, z, b] · F2[b, d]
        x2r, x2i = cmm("czb,bd->czd", zr, zi, F2r, F2i)
        sr, si = _sigma_cd(x2r, x2i, c_axis=0)
        ar_, ai_ = Ar[:, None, :], Ai[:, None, :]
        br_, bi_ = Br[:, None, :], Bi[:, None, :]
        zpr = ar_ * x2r - ai_ * x2i + br_ * sr - bi_ * si
        zpi = ar_ * x2i + ai_ * x2r + br_ * si + bi_ * sr
        # Inverse stage 2 (F2 symmetric ⇒ conj(F2)ᵀ = conj(F2)); 1/half
        # already folded into A/B.
        icr, ici = cmm("czd,db->czb", zpr, zpi, F2r, -F2i)
        wr = icr * tr + ici * ti
        wi = ici * tr - icr * ti
        # Inverse stage 1: M[z, a, b] = Σ_c conj(F1[c, a]) · W[c, z, b]
        ye, yo = cmm("ca,czb->zab", F1r, -F1i, wr, wi)
        return ye, yo

    # "batch" orientation: (z, ·, ·) leading everywhere.
    # Forward stage 1: Y[z, c, b] = Σ_a F1[c, a] · M[z, a, b]
    yr, yi = cmm("ca,zab->zcb", F1r, F1i, xe, xo)
    tr, ti = Twr[None, :, :], Twi[None, :, :]
    zr = yr * tr - yi * ti
    zi = yr * ti + yi * tr
    # Forward stage 2: X2[z, c, d] = Σ_b Z[z, c, b] · F2[b, d]
    x2r, x2i = cmm("zcb,bd->zcd", zr, zi, F2r, F2i)
    sr, si = _sigma_cd(x2r, x2i, c_axis=1)
    ar_, ai_ = Ar[None, :, :], Ai[None, :, :]
    br_, bi_ = Br[None, :, :], Bi[None, :, :]
    zpr = ar_ * x2r - ai_ * x2i + br_ * sr - bi_ * si
    zpi = ar_ * x2i + ai_ * x2r + br_ * si + bi_ * sr
    icr, ici = cmm("zcd,db->zcb", zpr, zpi, F2r, -F2i)
    wr = icr * tr + ici * ti
    wi = ici * tr - icr * ti
    # Inverse stage 1: M[z, a, b] = Σ_c conj(F1[c, a]) · W[z, c, b]
    ye, yo = cmm("ca,zcb->zab", F1r, -F1i, wr, wi)
    return ye, yo


@functools.partial(jax.jit, static_argnames=("nfft", "hist", "orientation"))
def _ols_filter_matmul_jit(x, tb, nfft: int, hist: int,
                           orientation: str = "batch"):
    half = nfft // 2
    hop = nfft - hist
    b, tp = x.shape
    t = tp - hist
    nframes = -(-t // hop)
    pad_tail = hist + nframes * hop - tp
    xp = jnp.pad(x, ((0, 0), (0, pad_tail))).astype(jnp.float32)
    # Even/odd split once on the signal, then frame at half length.
    v = xp.reshape(b, (tp + pad_tail) // 2, 2)
    frames_e = _frame_half(v[:, :, 0], half, hop // 2, nframes)
    frames_o = _frame_half(v[:, :, 1], half, hop // 2, nframes)
    n1, n2 = split_factors(half)
    z = b * nframes
    ye, yo = _ols_core(
        frames_e.reshape(z, n1, n2), frames_o.reshape(z, n1, n2), tb,
        orientation,
    )
    # Discard wrap-around (first hist samples = hist/2 packed), interleave.
    ye = ye.reshape(z, half)[:, hist // 2 :]
    yo = yo.reshape(z, half)[:, hist // 2 :]
    y = jnp.stack([ye, yo], -1).reshape(b, nframes * hop)
    return y[:, :t]


def ols_filter_matmul(x: jnp.ndarray, tables, nfft: int, hist: int,
                      orientation: str = "batch"):
    """Overlap-save on (B, hist+T) pre-padded input → (B, T) output.

    Drop-in replacement for the generic rfft/irfft overlap-save body
    (``fir._ols_filter``); ``tables = ols_tables(taps_padded, nfft)``.
    Requires ``nfft`` a power of two with ``nfft/2`` ≥ 16, and even
    ``hist``/``hop`` (guaranteed by ``ols_hop``'s power-of-two rounding).
    """
    return _ols_filter_matmul_jit(x, tables, nfft, hist, orientation)
