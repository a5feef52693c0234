"""FFT / IFFT / RFFT with a matmul-factored fast path.

Capability parity target: the reference's ``llz_fft.c/h`` (iterative
radix FFT with precomputed twiddles; mount empty — spec anchor
BASELINE.json:5 "FFT/STFT transforms").

Besides the FFT library (``jnp.fft``), the transforms can run as dense
matrix products, which suit a matrix unit better than scalar butterflies.
The four-step (Bailey) factorisation N = N1·N2:

    M[a, b]  = x[N2·a + b]                      (reshape)
    Y        = F_{N1} @ M                       (batched DFT matmul)
    Z[c, b]  = Y[c, b] · W_N^{b·c}              (twiddle, elementwise)
    X2       = Z @ F_{N2}                       (batched DFT matmul)
    X[N1·d + c] = X2[c, d]                      (transpose)

For N = 2048 that is 64×32; for 4096, 64×64.  The whole transform is 4
real matmuls per stage at f32 (bf16 would sink the 80 dB SNR budget,
BASELINE.json:5).  Complex values travel as an explicit (re, im) pair so
XLA emits pure f32 matmuls.  DFT/twiddle tables are computed in float64
on host and rounded once (SURVEY.md §7 hard part 2).

``method="xla"`` is ``jnp.fft``; ``method="auto"`` resolves to it on the
GPU and the CPU (:func:`_resolve_method`).  ``method="matmul"`` picks
among the dense, real four-step and packed-half engines by size
(``_DENSE_AUTO_MAX``, ``_auto_irfft_engine``); those size thresholds are
untuned defaults until the GPU sweep (ROADMAP A4).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.runtime.platform import backend

__all__ = [
    "fft",
    "ifft",
    "rfft",
    "irfft",
    "fft_matmul",
    "rfft_matmul",
    "rfft_pair",
    "pair_to_complex",
    "irfft_matmul",
    "split_factors",
    "precision_scope",
    "matmul_precision",
    "matmul_precision_name",
]


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def split_factors(n: int) -> Tuple[int, int]:
    """Balanced power-of-two split N = N1·N2 with N1 ≥ N2 (64·32 for 2048)."""
    if not _is_pow2(n):
        raise ValueError(f"matmul FFT requires power-of-two size, got {n}")
    lg = n.bit_length() - 1
    n1 = 1 << ((lg + 1) // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=64)
def _dft_tables(n: int) -> Tuple[np.ndarray, ...]:
    """Host-side f64→f32 DFT matrices and twiddles for the four-step FFT.

    Returns (F1r, F1i, F2r, F2i, Twr, Twi) with
    F1[c, a] = W_{N1}^{ca}, F2[b, d] = W_{N2}^{bd}, Tw[c, b] = W_N^{bc}.
    """
    n1, n2 = split_factors(n)
    a = np.arange(n1)
    F1 = np.exp(-2j * np.pi * np.outer(a, a) / n1)
    b = np.arange(n2)
    F2 = np.exp(-2j * np.pi * np.outer(b, b) / n2)
    c = np.arange(n1)
    Tw = np.exp(-2j * np.pi * np.outer(c, np.arange(n2)) / n)
    out = []
    for m in (F1, F2, Tw):
        out += [m.real.astype(np.float32), m.imag.astype(np.float32)]
    return tuple(out)


_PRECISION_OVERRIDE: Optional[str] = None


def matmul_precision_name() -> str:
    """Resolved precision NAME ("highest" | "high" | "default").

    This is what the public transform wrappers pass into their jitted
    helpers as a STATIC argument, so each precision gets its own trace —
    reading :func:`matmul_precision` at trace time inside a jit whose
    cache key ignores the override silently returns a stale-precision
    trace (ADVICE r3, medium).
    """
    import os

    name = (_PRECISION_OVERRIDE
            or os.environ.get("LLZ_MATMUL_PRECISION", "highest")).lower()
    if name not in ("highest", "high", "default"):
        raise ValueError(
            f"LLZ_MATMUL_PRECISION/precision_scope must be one of "
            f"highest|high|default, got {name!r}"
        )
    return name


def prec_enum(name: str):
    """The ``precision=`` argument for a matmul at tier ``name``.

    On the GPU ``"high"`` is an explicit three-pass bfloat16 product:
    ``Precision.HIGH`` lowers there to single-pass TF32, 71 dB on the
    headline chain, below the 80 dB bar.  The CPU computes every tier in
    float32 (and has no emitter for the three-pass algorithm on every
    shape)."""
    if name == "high" and backend() == "gpu":
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }[name]



def matmul_precision():
    """Matmul precision for all signal-path matmuls.

    A default-precision f32 matmul on the GPU runs single-pass TF32
    (10-bit mantissa), which caps the headline chain near 71 dB — under
    the 80 dB budget (BASELINE.json:5).  HIGHEST (full f32) is the
    default; LLZ_MATMUL_PRECISION=high trades SNR margin for speed with a
    three-pass bfloat16 product (:func:`prec_enum`).
    A :func:`precision_scope` override beats the env var — stages with
    their own accuracy budget (e.g. ``SpectralGainStage``) must not be
    silently degraded by a process-wide default.
    """
    return prec_enum(matmul_precision_name())


import contextlib


@contextlib.contextmanager
def precision_scope(name: Optional[str]):
    """Pin :func:`matmul_precision` to ``name`` ("highest" | "high" |
    "default") while tracing the enclosed computation; ``None`` is a
    no-op (inherit env).  Trace-time state — wrap the code that BUILDS
    the jaxpr, which is where the einsum precision attribute is fixed.
    """
    global _PRECISION_OVERRIDE
    if name is None:
        yield
        return
    prev = _PRECISION_OVERRIDE
    _PRECISION_OVERRIDE = name.lower()
    try:
        yield
    finally:
        _PRECISION_OVERRIDE = prev


def _cmatmul(ar, ai, br, bi, eq: str, prec: str = None):
    """Complex matmul via THREE real einsums (Karatsuba/Gauss form:
    t = Ar·Br, u = Ai·Bi, v = (Ar+Ai)·(Br+Bi); re = t − u,
    im = v − t − u).  25% less matmul work than the naive 4-dot form; the
    weight-side sum folds to a compile-time constant.  The extra
    additions cost ~1 ulp."""
    kw = dict(
        preferred_element_type=jnp.float32,
        precision=prec_enum(prec) if prec else matmul_precision(),
    )
    t = jnp.einsum(eq, ar, br, **kw)
    u = jnp.einsum(eq, ai, bi, **kw)
    v = jnp.einsum(eq, ar + ai, br + bi, **kw)
    return t - u, v - t - u


def _fft_matmul_core(xr: jnp.ndarray, xi: jnp.ndarray, n: int,
                     prec: str = None):
    """Four-step FFT on the last axis of (B, N) real/imag parts."""
    n1, n2 = split_factors(n)
    F1r, F1i, F2r, F2i, Twr, Twi = (jnp.asarray(t) for t in _dft_tables(n))
    mr = xr.reshape(-1, n1, n2)
    mi = xi.reshape(-1, n1, n2)
    # Stage 1: Y[c,b] = Σ_a F1[c,a] M[a,b]
    yr, yi = _cmatmul(F1r, F1i, mr, mi, "ca,zab->zcb", prec)
    # Twiddle: Z = Y ⊙ W_N^{bc}
    zr = yr * Twr - yi * Twi
    zi = yr * Twi + yi * Twr
    # Stage 2: X2[c,d] = Σ_b Z[c,b] F2[b,d]
    x2r, x2i = _cmatmul(zr, zi, F2r, F2i, "zcb,bd->zcd", prec)
    # Output ordering X[N1·d + c] = X2[c,d] → transpose (c,d) → (d,c)
    outr = x2r.transpose(0, 2, 1).reshape(-1, n)
    outi = x2i.transpose(0, 2, 1).reshape(-1, n)
    return outr, outi


@functools.lru_cache(maxsize=32)
def _cdft_dense_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, n) cos/−sin full DFT tables for the dense COMPLEX engine
    (8·n² bytes — capped like the real dense tables)."""
    if n > CDENSE_TABLE_MAX_N:
        raise ValueError(
            f"dense complex DFT tables at n={n} would cost "
            f"{8 * n * n / 1e9:.2f} GB (8·n² bytes); use the four-step "
            f"engine (auto does)")
    j = np.arange(n)
    ang = -2.0 * np.pi * np.outer(j, j) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


#: complex dense table cap (8·n² bytes: 2048 → 33.6 MB, 4096 → 134 MB)
CDENSE_TABLE_MAX_N = 2048


def _cfft_dense_core(xr: jnp.ndarray, xi: jnp.ndarray, n: int, prec: str):
    """Dense complex DFT: (xr + j·xi) @ (C + j·S) via the Gauss 3-dot
    complex matmul — one K=n, N=n contraction, zero intermediates, zero
    transposes (the complex analog of ``_rfft_dense_core``)."""
    Cr, Ci = (jnp.asarray(t) for t in _cdft_dense_tables(n))
    return _cmatmul(xr, xi, Cr, Ci, "zj,jk->zk", prec)


#: complex-fft engine under method="matmul": dense up to these sizes,
#: four-step above (untuned defaults, ROADMAP A4).
_CDENSE_AUTO_MAX = {"high": 1024, "default": 1024, "highest": 512}


def _auto_cfft_engine(n: int, prec: str) -> str:
    return ("cdense" if n <= _CDENSE_AUTO_MAX.get(prec, 512)
            else "fourstep")


@functools.partial(jax.jit, static_argnames=("n", "prec", "engine"))
def _fft_matmul_jit(xr, xi, n, prec="highest", engine="auto"):
    shape = xr.shape
    xrb = xr.reshape(-1, n).astype(jnp.float32)
    xib = xi.reshape(-1, n).astype(jnp.float32)
    if engine == "auto":
        engine = _auto_cfft_engine(n, prec)
    if engine == "cdense":
        outr, outi = _cfft_dense_core(xrb, xib, n, prec)
    else:
        outr, outi = _fft_matmul_core(xrb, xib, n, prec)
    return outr.reshape(shape), outi.reshape(shape)


# Complex construction/split/conjugate in the public wrappers, jitted
# (inlined for free when the caller is already jitting).
_jit_pack = jax.jit(jax.lax.complex)
_jit_split = jax.jit(lambda v: (jnp.real(v).astype(jnp.float32),
                                jnp.imag(v).astype(jnp.float32)))
_jit_conj = jax.jit(jnp.conj)
_jit_conj_div = jax.jit(lambda v, s: jnp.conj(v) / s)


def fft_matmul(x: jnp.ndarray, n: Optional[int] = None) -> jnp.ndarray:
    """Complex FFT (last axis) via factored matmuls.  Accepts real or
    complex input; returns complex64."""
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] != n:
        x = _pad_or_trim(x, n)
    if jnp.iscomplexobj(x):
        xr, xi = _jit_split(x)
    else:
        xr = x.astype(jnp.float32)
        xi = jnp.zeros_like(xr)
    outr, outi = _fft_matmul_jit(xr, xi, n, matmul_precision_name())
    return _jit_pack(outr, outi)


@functools.lru_cache(maxsize=64)
def _rdft_tables(n: int, n1: Optional[int] = None) -> Tuple[np.ndarray, ...]:
    """Host f64→f32 tables for the REAL-input four-step rfft.

    Index split j = a + N1·b (a < N1, b < N2) and k = c·N2 + d gives
        X[c·N2 + d] = Σ_a W_{N1}^{ac} · W_N^{ad} · (Σ_b x[a+N1·b] W_{N2}^{bd})
    so the inner stage is a REAL matmul (2 real dots), the twiddle is
    (N1, N2), and the outer stage only needs rows c = 0..N1/2 — the
    conjugate-symmetric half IS the rfft output, already in k order.
    """
    if n1 is None:
        n1, n2 = split_factors(n)
    else:
        n2 = n // n1
    nh = n1 // 2
    b = np.arange(n2)
    F2 = np.exp(-2j * np.pi * np.outer(b, b) / n2)
    a = np.arange(n1)
    Tw = np.exp(-2j * np.pi * np.outer(a, np.arange(n2)) / n)
    F1h = np.exp(-2j * np.pi * np.outer(np.arange(nh + 1), a) / n1)
    out = []
    for m in (F2, Tw, F1h):
        out += [m.real.astype(np.float32), m.imag.astype(np.float32)]
    return tuple(out)


def _rfft_real_core(xb: jnp.ndarray, n: int, prec: str,
                    n1: Optional[int] = None):
    """Real-input four-step rfft on (B, n) f32 rows → (B, n/2+1) pair.

    No even/odd pack, no spectral mirror/untangle, no output transpose:
    the input reshape (B, N2, N1) is the natural row-major view of
    x[a + N1·b] with b as rows, bins come out as (c, d) ↦ k = c·N2+d
    (a plain reshape), and conjugate symmetry halves the outer-stage
    MACs instead of requiring a post-pass.  ~1.7× the MACs of the
    packed-half formulation but a small fraction of its data movement.

    ``n1`` overrides the factor split: small n1 (e.g. 16) makes the
    inner stage a (128, 128) contraction at the cost of a tiny-K outer
    stage.
    """
    if n1 is None:
        n1, n2 = split_factors(n)
    else:
        n2 = n // n1
    nh = n1 // 2
    C2, S2, Twr, Twi, F1r, F1i = (jnp.asarray(t)
                                  for t in _rdft_tables(n, n1))
    kw = dict(preferred_element_type=jnp.float32, precision=prec_enum(prec))
    Mt = xb.reshape(-1, n2, n1)             # Mt[z, b, a] = x[a + N1·b]
    # Stage A (real input, 2 real dots): Y[a,d] = Σ_b M[a,b]·F2[b,d]
    Yr = jnp.einsum("zba,bd->zad", Mt, C2, **kw)
    Yi = jnp.einsum("zba,bd->zad", Mt, S2, **kw)
    # Twiddle: Z[a,d] = Y[a,d] · W_N^{ad}
    Zr = Yr * Twr - Yi * Twi
    Zi = Yr * Twi + Yi * Twr
    # Stage B (halved output): X[c,d] = Σ_a F1h[c,a]·Z[a,d], c = 0..N1/2
    Xr, Xi = _cmatmul(F1r, F1i, Zr, Zi, "ca,zad->zcd", prec)
    bsz = Xr.shape[0]
    outr = jnp.concatenate(
        [Xr[:, :nh, :].reshape(bsz, nh * n2), Xr[:, nh, :1]], axis=-1)
    outi = jnp.concatenate(
        [Xi[:, :nh, :].reshape(bsz, nh * n2), Xi[:, nh, :1]], axis=-1)
    return outr, outi


#: dense-rDFT table cap: the (n, n/2) cos/sin pair costs 4·n² bytes
#: (n=4096 → 67 MB allowed; n=8192 → 268 MB, n=16384 → 1.07 GB).
#: Above 4096 the tables crowd device memory and the O(n²) MACs grow
#: past the four-step's; explicit engine="dense" raises above the cap.
DENSE_TABLE_MAX_N = 4096


def _check_dense_n(n: int):
    if n > DENSE_TABLE_MAX_N:
        raise ValueError(
            f"dense rDFT tables at n={n} would cost "
            f"{4 * n * n / 1e9:.2f} GB (4·n² bytes) — use "
            f"engine='real' or 'pack' (auto does)")


@functools.lru_cache(maxsize=32)
def _rdft_dense_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, n/2) cos/−sin tables for bins 1..n/2 (DC comes from a row
    sum, so N is exactly n/2 — no 1025→1152 padding)."""
    _check_dense_n(n)
    j = np.arange(n)[:, None]
    k = np.arange(1, n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * j * k / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _rfft_dense_core(xb: jnp.ndarray, n: int, prec: str):
    """Dense rDFT: X[1..n/2] = x @ (C + jS), DC = Σx.

    Spends ~12× the four-step's MACs to buy a matrix unit's favourite
    shape — one (B, n) @ (n, n/2) real matmul pair, K = n, N = n/2, zero
    intermediates, zero relayouts — where the four-step's stages are
    small K,N ∈ {32, 64} contractions.
    """
    Cr, Ci = (jnp.asarray(t) for t in _rdft_dense_tables(n))
    kw = dict(preferred_element_type=jnp.float32, precision=prec_enum(prec))
    Xr = jnp.einsum("zj,jk->zk", xb, Cr, **kw)
    Xi = jnp.einsum("zj,jk->zk", xb, Ci, **kw)
    dc = jnp.sum(xb, axis=-1, keepdims=True)
    outr = jnp.concatenate([dc, Xr], axis=-1)
    outi = jnp.concatenate([jnp.zeros_like(dc), Xi], axis=-1)
    return outr, outi


@functools.partial(jax.jit, static_argnames=("n", "prec", "engine"))
def _rfft_matmul_jit(x, n, prec="highest", engine="real"):
    """Real FFT of size n.

    engine="real": real-input four-step (see :func:`_rfft_real_core`).
    engine="pack": the classic half-size complex FFT + conjugate-symmetric
    untangle.

    Pack derivation: z[m] = x[2m] + j·x[2m+1]; with Z = FFT_{n/2}(z) and
    Zc[k] = conj(Z[(n/2-k) mod n/2]):
        E = (Z + Zc)/2,  O = -j·(Z − Zc)/2,
        X[k] = E[k] + W_n^k · O[k],  k = 0..n/2  (X[n/2] from wraparound).
    """
    half = n // 2
    shape = x.shape
    xb = x.reshape(-1, n).astype(jnp.float32)
    if engine in ("real", "real16", "dense"):
        if engine == "dense":
            outr, outi = _rfft_dense_core(xb, n, prec)
        else:
            n1 = 16 if (engine == "real16" and n % 16 == 0
                        and n >= 256) else None
            outr, outi = _rfft_real_core(xb, n, prec, n1)
        out_shape = shape[:-1] + (half + 1,)
        return outr.reshape(out_shape), outi.reshape(out_shape)
    zr = xb[:, 0::2]
    zi = xb[:, 1::2]
    # the inner half-size transform stays four-step at every size
    Zr, Zi = _fft_matmul_core(zr, zi, half, prec)
    # Z[(-k) mod half]: bin 0 fixed, bins 1..half-1 reversed — expressed as
    # slice+reverse+concat (lax.rev is a plain relayout; no gather).
    def _mirror(t):
        return jnp.concatenate([t[:, :1], jnp.flip(t[:, 1:], axis=-1)], -1)
    Zcr = _mirror(Zr)
    Zci = -_mirror(Zi)
    Er = 0.5 * (Zr + Zcr)
    Ei = 0.5 * (Zi + Zci)
    Or = 0.5 * (Zi - Zci)
    Oi = -0.5 * (Zr - Zcr)
    k = np.arange(half)
    w = np.exp(-2j * np.pi * k / n)
    wr = jnp.asarray(w.real.astype(np.float32))
    wi = jnp.asarray(w.imag.astype(np.float32))
    Xr = Er + wr * Or - wi * Oi
    Xi = Ei + wr * Oi + wi * Or
    # Bin n/2 (Nyquist): X[n/2] = E[0] - O[0]
    xnyq_r = (Er[:, :1] - Or[:, :1])
    xnyq_i = (Ei[:, :1] - Oi[:, :1])
    outr = jnp.concatenate([Xr, xnyq_r], axis=-1)
    outi = jnp.concatenate([Xi, xnyq_i], axis=-1)
    out_shape = shape[:-1] + (half + 1,)
    return outr.reshape(out_shape), outi.reshape(out_shape)


#: size ceiling for the dense rDFT under engine="auto", per precision:
#: dense up to it, packed-half at 4096, real four-step at 8192+.  The
#: O(n²) MAC growth eventually loses to the four-step's O(n·√n).
#: Untuned defaults until the GPU sweep (ROADMAP A4).
_DENSE_AUTO_MAX = {"high": 2048, "default": 2048, "highest": 1024}


def _auto_rfft_engine(n: int, prec: str) -> str:
    if n <= _DENSE_AUTO_MAX.get(prec, 1024):
        return "dense"
    if n == 4096:
        return "pack"
    return "real"


def rfft_matmul(x: jnp.ndarray, n: Optional[int] = None, *,
                engine: str = "auto") -> jnp.ndarray:
    """rfft via matmuls.  ``engine="auto"`` resolves by precision and
    size (see ``_DENSE_AUTO_MAX``)."""
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] != n:
        x = _pad_or_trim(x, n)
    prec = matmul_precision_name()
    if engine == "auto":
        engine = _auto_rfft_engine(n, prec)
    outr, outi = _rfft_matmul_jit(x, n, prec, engine)
    return _jit_pack(outr, outi)


@functools.lru_cache(maxsize=64)
def _irdft_real_tables(n: int) -> Tuple[np.ndarray, ...]:
    """Tables for the REAL-OUTPUT four-step irfft (mirror of
    :func:`_rfft_real_core`): F1f[a,c] = ω_{N1}^{+ac} (full N1), the
    conjugate twiddle (N1, N2), and the final real stage
    C2t/S2t[d,b] = cos/sin(2πbd/N2) with the 1/n scale folded in."""
    n1, n2 = split_factors(n)
    a = np.arange(n1)
    F1f = np.exp(2j * np.pi * np.outer(a, a) / n1)
    Tw = np.exp(2j * np.pi * np.outer(a, np.arange(n2)) / n)
    d = np.arange(n2)
    ang = 2.0 * np.pi * np.outer(d, d) / n2
    return (F1f.real.astype(np.float32), F1f.imag.astype(np.float32),
            Tw.real.astype(np.float32), Tw.imag.astype(np.float32),
            (np.cos(ang) / n).astype(np.float32),
            (np.sin(ang) / n).astype(np.float32))


def _irfft_real_core(sr: jnp.ndarray, si: jnp.ndarray, n: int, prec: str):
    """Real-output four-step irfft on (B, n/2+1) spectrum rows → (B, n).

    Rebuilds the full (N1, N2) spectral grid from the stored half via
    conjugate symmetry (k = c·N2 + d; for c > N1/2 the partner row is
    N1−1−c with a d-mirror, except the d=0 column whose partner is row
    N1−c), then inverts the four-step: G = F1f @ Xf (Gauss 3-dot),
    conjugate twiddle, and a REAL final stage (only Re is computed — the
    output is real by construction), emitted directly in the natural
    x[a + N1·b] layout (einsum to "zba", a plain reshape away from x).
    """
    n1, n2 = split_factors(n)
    nh = n1 // 2
    F1r, F1i, Twr, Twi, C2t, S2t = (jnp.asarray(t)
                                    for t in _irdft_real_tables(n))
    bsz = sr.shape[0]
    # stored bins 0..n/2−1 ARE rows 0..nh−1 of the (c, d) grid
    top_r = sr[:, : nh * n2].reshape(bsz, nh, n2)
    top_i = si[:, : nh * n2].reshape(bsz, nh, n2)
    # row nh: lane 0 is the stored Nyquist bin; lanes d>0 are
    # k = nh·n2+d > n/2 → conj(X[nh−1, n2−d]) (n−k lands on row nh−1)
    rnh_r = jnp.concatenate(
        [sr[:, nh * n2 :], jnp.flip(top_r[:, nh - 1, 1:], axis=-1)],
        axis=-1)[:, None, :]
    rnh_i = jnp.concatenate(
        [si[:, nh * n2 :], -jnp.flip(top_i[:, nh - 1, 1:], axis=-1)],
        axis=-1)[:, None, :]
    # rows c = nh+1 .. n1−1:
    #   d = 0:  conj(X[n1−c, 0])      → rows nh−1..1, lane 0
    #   d > 0:  conj(X[n1−1−c, n2−d]) → rows nh−2..0, lanes mirrored
    body_r = jnp.flip(top_r[:, 0 : nh - 1, :], axis=-2)
    body_i = jnp.flip(top_i[:, 0 : nh - 1, :], axis=-2)
    lane0_r = jnp.flip(top_r[:, 1:nh, 0:1], axis=-2)
    lane0_i = jnp.flip(top_i[:, 1:nh, 0:1], axis=-2)
    low_r = jnp.concatenate(
        [lane0_r, jnp.flip(body_r[:, :, 1:], axis=-1)], axis=-1)
    low_i = -jnp.concatenate(
        [lane0_i, jnp.flip(body_i[:, :, 1:], axis=-1)], axis=-1)
    Xr = jnp.concatenate([top_r, rnh_r, low_r], axis=-2)  # (B, n1, n2)
    Xi = jnp.concatenate([top_i, rnh_i, low_i], axis=-2)
    # G[a, d] = Σ_c F1f[a, c]·Xf[c, d]
    Gr, Gi = _cmatmul(F1r, F1i, Xr, Xi, "ac,zcd->zad", prec)
    # conjugate twiddle
    Zr = Gr * Twr - Gi * Twi
    Zi = Gr * Twi + Gi * Twr
    # real final stage, emitted in natural x[a + N1·b] order
    kw = dict(preferred_element_type=jnp.float32, precision=prec_enum(prec))
    out = (jnp.einsum("zad,db->zba", Zr, C2t, **kw)
           - jnp.einsum("zad,db->zba", Zi, S2t, **kw))
    return out.reshape(out.shape[0], n)


@functools.lru_cache(maxsize=32)
def _irdft_dense_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n/2, n) inverse-rDFT tables over bins 1..n/2 (K exactly n/2).
    Capped at DENSE_TABLE_MAX_N like the forward tables.

    Row k<n/2: 2·cos(2πjk/n)/n and −2·sin(2πjk/n)/n (the conjugate pair
    folded in); row n/2 (Nyquist): (−1)^j/n with zero imaginary weight
    (irfft ignores Im at Nyquist by convention).  DC is an elementwise add.
    """
    _check_dense_n(n)
    j = np.arange(n)[None, :]
    k = np.arange(1, n // 2 + 1)[:, None]
    ang = 2.0 * np.pi * j * k / n
    cr = 2.0 * np.cos(ang) / n
    ci = -2.0 * np.sin(ang) / n
    cr[-1, :] = np.where(np.arange(n) % 2 == 0, 1.0, -1.0) / n
    ci[-1, :] = 0.0
    return cr.astype(np.float32), ci.astype(np.float32)


def _irfft_dense_core(sr: jnp.ndarray, si: jnp.ndarray, n: int, prec: str):
    """Dense inverse rDFT on (B, n/2+1) spectrum rows → (B, n) f32."""
    Cr, Ci = (jnp.asarray(t) for t in _irdft_dense_tables(n))
    kw = dict(preferred_element_type=jnp.float32, precision=prec_enum(prec))
    x = (jnp.einsum("zk,kj->zj", sr[:, 1:], Cr, **kw)
         + jnp.einsum("zk,kj->zj", si[:, 1:], Ci, **kw))
    return x + sr[:, :1] / n


@functools.partial(jax.jit, static_argnames=("n", "prec", "engine"))
def _irfft_matmul_jit(specr, speci, n, prec="highest", engine="pack"):
    """Inverse real FFT of size n via one complex inverse FFT of size n/2.

    Reverses the packing of ``_rfft_matmul_jit``: rebuild
    Z[k] = E[k] + j·W_n^{-k}·O[k] from the spectrum's conjugate symmetry,
    inverse-transform, and interleave real/imag as even/odd samples.
    """
    half = n // 2
    shape = specr.shape
    sr = specr.reshape(-1, half + 1).astype(jnp.float32)
    si = speci.reshape(-1, half + 1).astype(jnp.float32)
    if engine == "dense":
        out = _irfft_dense_core(sr, si, n, prec)
        return out.reshape(shape[:-1] + (n,))
    if engine == "real":
        out = _irfft_real_core(sr, si, n, prec)
        return out.reshape(shape[:-1] + (n,))
    Xr, Xi = sr[:, :half], si[:, :half]
    # Xc[k] = conj(X[n/2 - k]) for k = 0..n/2-1: bins n/2..1 reversed —
    # a pure lax.rev of bins 1..n/2 (no gather).
    Xcr = jnp.flip(sr[:, 1:], axis=-1)
    Xci = -jnp.flip(si[:, 1:], axis=-1)
    Er = 0.5 * (Xr + Xcr)
    Ei = 0.5 * (Xi + Xci)
    k = np.arange(half)
    w = np.exp(2j * np.pi * k / n)  # W_n^{-k}
    wr = jnp.asarray(w.real.astype(np.float32))
    wi = jnp.asarray(w.imag.astype(np.float32))
    Dr = 0.5 * (Xr - Xcr)
    Di = 0.5 * (Xi - Xci)
    # O[k] = W_n^{-k} · (X[k] − Xc[k])/2 ... recovered odd part
    Or_ = wr * Dr - wi * Di
    Oi_ = wr * Di + wi * Dr
    # Z[k] = E[k] + j·O'[k]  where O'[k] = W^{-k}·O-part; j·(a+jb) = -b + ja
    Zr = Er - Oi_
    Zi = Ei + Or_
    # inverse complex FFT of size half: ifft(z) = conj(fft(conj(z)))/half
    fr, fi = _fft_matmul_core(Zr, -Zi, half, prec)  # see forward note
    zr = fr / half
    zi = -fi / half
    out = jnp.stack([zr, zi], axis=-1).reshape(-1, n)
    return out.reshape(shape[:-1] + (n,))


def _auto_irfft_engine(n: int, prec: str) -> str:
    """Inverse engine by size: dense ≤ 1024, real-output four-step at
    4096, packed-half elsewhere (untuned defaults, ROADMAP A4)."""
    if n <= 1024:
        return "dense"
    if n == 4096:
        return "real"
    return "pack"


def irfft_matmul(spec: jnp.ndarray, n: Optional[int] = None, *,
                 engine: str = "auto") -> jnp.ndarray:
    """Inverse rfft via matmuls.

    ``engine="auto"`` resolves by size (:func:`_auto_irfft_engine`).
    ``engine=`` accepts pack/dense/real explicitly (e.g. "dense" when a
    chain's budget needs the extra ~3.5 dB at high precision)."""
    if n is None:
        n = 2 * (spec.shape[-1] - 1)
    prec = matmul_precision_name()
    if engine == "auto":
        engine = _auto_irfft_engine(n, prec)
    sr, si = _jit_split(spec)
    return _irfft_matmul_jit(sr, si, n, prec, engine)


@functools.lru_cache(maxsize=32)
def _rdft_pair_tables(n: int) -> np.ndarray:
    """Combined ``(n, n+2)`` [re | im] rDFT table with the DC row-sum
    folded in as a ones column: col 0 = DC(re), cols 1..n/2 = cos bins
    1..n/2, col n/2+1 = DC(im) ≡ 0, cols n/2+2..n+1 = −sin bins.
    ONE matmul produces the full (re, im) spectrum pair — no second
    einsum re-reading the signal, no DC sum pass, no concat, no
    complex64 pack."""
    Cr, Ci = _rdft_dense_tables(n)
    w = np.zeros((n, n + 2), np.float32)
    w[:, 0] = 1.0
    w[:, 1 : n // 2 + 1] = Cr
    w[:, n // 2 + 2 :] = Ci
    return w


@functools.partial(jax.jit, static_argnames=("n", "prec"))
def _rfft_pair_jit(x, n, prec="high"):
    shape = x.shape
    xb = x.reshape(-1, n).astype(jnp.float32)
    W = jnp.asarray(_rdft_pair_tables(n))
    out = jnp.einsum("zj,jk->zk", xb, W,
                     preferred_element_type=jnp.float32,
                     precision=prec_enum(prec))
    return out.reshape(shape[:-1] + (n + 2,))


def rfft_pair(x: jnp.ndarray, n: Optional[int] = None) -> jnp.ndarray:
    """rfft in the (re, im)-PAIR layout: output ``(..., n+2)`` f32 with
    ``out[..., :n//2+1]`` the real parts of bins 0..n/2 and
    ``out[..., n//2+1:]`` the imaginary parts (bin-0 imag ≡ 0) — this
    framework's spectral format for chain-internal use.
    Values equal ``rfft_matmul(x, n, engine="dense")`` — same tables,
    same contraction — via one (B, n) @ (n, n+2) matmul.
    """
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] != n:
        x = _pad_or_trim(x, n)
    return _rfft_pair_jit(x, n, matmul_precision_name())


def pair_to_complex(spec: jnp.ndarray) -> jnp.ndarray:
    """Convert a pair-layout spectrum ``(..., n+2)`` to complex64
    ``(..., n/2+1)``."""
    half1 = spec.shape[-1] // 2
    return _jit_pack(spec[..., :half1], spec[..., half1:])


def _pad_or_trim(x: jnp.ndarray, n: int) -> jnp.ndarray:
    t = x.shape[-1]
    if t == n:
        return x
    if t > n:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - t)]
    return jnp.pad(x, pad)


def _resolve_method(method: str, n: int) -> str:
    """``"auto"`` is the FFT library on the GPU and the CPU; the GPU
    choice is unmeasured against the matmul engines (ROADMAP A4)."""
    if method == "auto":
        return {"gpu": "xla", "cpu": "xla"}[backend()]
    return method


def fft(x: jnp.ndarray, n: Optional[int] = None, *, method: str = "auto"):
    """Complex FFT along the last axis.  ``method``: auto | xla | matmul."""
    n = n or x.shape[-1]
    m = _resolve_method(method, n)
    if m == "matmul":
        return fft_matmul(x, n)
    return jnp.fft.fft(x, n=n, axis=-1)


def ifft(x: jnp.ndarray, n: Optional[int] = None, *, method: str = "auto"):
    n = n or x.shape[-1]
    m = _resolve_method(method, n)
    if m == "matmul":
        return _jit_conj_div(fft_matmul(_jit_conj(x), n), float(n))
    return jnp.fft.ifft(x, n=n, axis=-1)


def rfft(x: jnp.ndarray, n: Optional[int] = None, *, method: str = "auto"):
    n = n or x.shape[-1]
    m = _resolve_method(method, n)
    if m == "matmul" and n % 2 == 0:
        return rfft_matmul(x, n)
    return jnp.fft.rfft(x, n=n, axis=-1)


def irfft(x: jnp.ndarray, n: Optional[int] = None, *, method: str = "auto"):
    n = n or 2 * (x.shape[-1] - 1)
    m = _resolve_method(method, n)
    if m == "matmul" and n % 2 == 0:
        return irfft_matmul(x, n)
    return jnp.fft.irfft(x, n=n, axis=-1)
