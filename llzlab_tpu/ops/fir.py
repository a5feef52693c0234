"""FIR filter design and filtering.

Capability parity target: the reference's ``llz_fir.c/h`` (window-method
design + overlap-save fast convolution; mount empty — spec anchors
BASELINE.json:5 "FIR convolution via overlap-save" and BASELINE.json:7
"1024-tap FIR lowpass on 10s of 48kHz float32 audio").

Design is host-side float64 numpy (scipy.signal.firwin-equivalent
semantics).  Filtering:

* ``method="ols"`` — overlap-save block fast convolution: frames of
  ``nfft`` samples with ``ntaps-1`` halo, rfft → spectral multiply →
  irfft, discard wrap-around.  Memory-bandwidth-bound for long filters.
* ``method="direct"`` — ``lax.conv_general_dilated``; XLA lowers 1-D conv
  without materialising an im2col in device memory.
* ``method="block2"`` / ``"im2col"`` — Toeplitz matmul forms.
* ``method="auto"`` picks by tap count (:func:`fir_method_auto`).

Streaming semantics are causal with zero (or caller-provided ``zi``)
initial history; splitting a signal at any block boundary and carrying
``zf`` reproduces the unsplit output bit-for-bit (same frames, same
arithmetic — the overlap-save frame grid is anchored at the signal start).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from llzlab_tpu.ops.window import get_window
from llzlab_tpu.ops.transform import matmul_precision as _matmul_precision

__all__ = [
    "firwin",
    "firwin2",
    "kaiser_beta",
    "kaiser_atten",
    "kaiserord",
    "firls",
    "minimum_phase",
    "fir_filter",
    "fir_halo",
    "default_nfft",
    "ols_hop",
    "fir_state_len",
    "block2_block",
]


# ---------------------------------------------------------------------------
# Design (host-side, float64)
# ---------------------------------------------------------------------------


def _sinc_bands(m: np.ndarray, bands: Sequence[tuple]) -> np.ndarray:
    """Ideal impulse response for a union of passbands (edges in Nyquist units)."""
    h = np.zeros_like(m)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    return h


def firwin(
    numtaps: int,
    cutoff: Union[float, Sequence[float]],
    *,
    window="hamming",
    pass_zero: Union[bool, str] = True,
    fs: float = 2.0,
) -> np.ndarray:
    """Window-method FIR design (lowpass/highpass/bandpass/bandstop).

    Matches ``scipy.signal.firwin`` semantics: ``cutoff`` in the same units
    as ``fs`` (default Nyquist units), ``pass_zero`` selecting whether DC is
    in a passband (or one of "lowpass"/"highpass"/"bandpass"/"bandstop").
    Returns float64 taps; cast at the filtering site.
    """
    if isinstance(pass_zero, str):
        pass_zero = pass_zero.lower() in ("lowpass", "bandstop")
    cut = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) * 2.0 / fs
    if np.any(cut <= 0) or np.any(cut >= 1):
        raise ValueError("cutoff must lie strictly inside (0, fs/2)")
    if np.any(np.diff(cut) <= 0):
        raise ValueError("cutoff frequencies must be strictly increasing")

    # Build band edges: prepend 0 if DC passes, append 1 if Nyquist passes.
    edges = list(cut)
    if pass_zero:
        edges = [0.0] + edges
    if len(edges) % 2 == 1:
        edges = edges + [1.0]
    passes_nyquist = edges[-1] == 1.0
    if passes_nyquist and numtaps % 2 == 0:
        raise ValueError(
            "an even number of taps cannot pass Nyquist (type II zero at fs/2); "
            "use odd numtaps"
        )
    bands = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]

    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps, dtype=np.float64) - alpha
    h = _sinc_bands(m, bands)
    h *= get_window(window, numtaps, periodic=False)

    # Normalise unity gain at the reference frequency of the first passband
    # (DC if it passes zero, Nyquist if it touches fs/2, else band centre).
    left, right = bands[0]
    if left == 0.0:
        fc = 0.0
    elif right == 1.0:
        fc = 1.0
    else:
        fc = 0.5 * (left + right)
    scale = np.sum(h * np.cos(np.pi * m * fc))
    h /= scale
    return h


def firwin2(
    numtaps: int,
    freq,
    gain,
    *,
    nfreqs: Optional[int] = None,
    window="hamming",
    fs: float = 2.0,
) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2 semantics).

    ``freq`` (monotone, 0 … fs/2 with both endpoints present) and ``gain``
    define the desired magnitude; the linear-phase response is sampled on a
    fine grid, inverse-rFFT'd, truncated to ``numtaps`` and windowed.
    """
    freq = np.asarray(freq, np.float64) * 2.0 / fs
    gain = np.asarray(gain, np.float64)
    if freq[0] != 0.0 or freq[-1] != 1.0:
        raise ValueError("freq must start at 0 and end at fs/2")
    if np.any(np.diff(freq) < 0):
        raise ValueError("freq must be nondecreasing")
    if numtaps % 2 == 0 and gain[-1] != 0.0:
        raise ValueError("even numtaps needs zero gain at Nyquist (type II)")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(max(numtaps, 2))))
    # Nudge duplicate interior frequencies apart (step responses).
    eps = np.finfo(np.float64).eps
    fq = freq.copy()
    for i in range(1, len(fq)):
        if fq[i] <= fq[i - 1]:
            fq[i] = fq[i - 1] + eps * (i + 1)
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, fq, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x)
    h_full = np.fft.irfft(fx * shift)
    h = h_full[:numtaps] * get_window(window, numtaps, periodic=False)
    return h


def kaiser_beta(a: float) -> float:
    """Kaiser window β for ``a`` dB of stopband attenuation."""
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a Kaiser-window FIR with the given transition
    ``width`` (Nyquist units)."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiserord(ripple: float, width: float):
    """(numtaps, beta) meeting ``ripple`` dB over a ``width`` transition
    (scipy.signal.kaiserord semantics; width in Nyquist units)."""
    a = abs(ripple)
    if a < 8.0:
        raise ValueError("ripple attenuation too small for Kaiser (min 8 dB)")
    beta = kaiser_beta(a)
    numtaps = (a - 7.95) / (2.285 * np.pi * width) + 1
    return int(math.ceil(numtaps)), beta


def firls(numtaps: int, bands, desired, *, weight=None,
          fs: float = 2.0) -> np.ndarray:
    """Least-squares linear-phase FIR design (scipy.signal.firls semantics).

    Minimises the weighted integrated squared error between the type-I
    amplitude response and the piecewise-linear ``desired`` over ``bands``
    (band-edge pairs in Hz).  Host-side float64: the normal equations
    ``Q a = b`` use the closed-form cosine-product band integrals
    (Q = ½·(Toeplitz(q) + Hankel(q))), so no frequency grid is involved.

    ``numtaps`` must be odd (type I).  ``weight`` is one constant per band.
    """
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd and >= 1")
    m = (numtaps - 1) // 2
    bands = np.asarray(bands, np.float64).reshape(-1, 2) * (2.0 / fs)
    desired = np.asarray(desired, np.float64).reshape(-1, 2)
    if bands.shape[0] != desired.shape[0]:
        raise ValueError("desired must have one value per band edge")
    if weight is None:
        weight = np.ones(bands.shape[0])
    weight = np.asarray(weight, np.float64)

    # q[j] = sum_bands W \int cos(pi j f) df,  j = 0 .. 2m
    j = np.arange(2 * m + 1, dtype=np.float64)
    f0, f1 = bands[:, 0][:, None], bands[:, 1][:, None]
    # (bands, j): f*sinc(j f) = sin(pi j f)/(pi j), exact at j=0
    q = np.sum(weight[:, None]
               * (f1 * np.sinc(j * f1) - f0 * np.sinc(j * f0)), axis=0)

    # b[k] = sum_bands W \int D(f) cos(pi k f) df with D linear in f.
    # \int f cos(af) df = cos(af)/a^2 + f sin(af)/a  (a = pi k).
    k = np.arange(m + 1, dtype=np.float64)
    d0, d1 = desired[:, 0][:, None], desired[:, 1][:, None]
    slope = (d1 - d0) / np.where(f1 > f0, f1 - f0, 1.0)
    c0 = d0 - slope * f0  # D(f) = c0 + slope*f
    # constant part: c0 * (f sinc(k f)) |_{f0}^{f1}
    b = np.sum(weight[:, None] * c0
               * (f1 * np.sinc(k * f1) - f0 * np.sinc(k * f0)), axis=0)
    # linear part: slope * [cos(pi k f)/(pi k)^2 + f sin(pi k f)/(pi k)]
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.pi * k
        lin1 = (np.cos(a * f1) - np.cos(a * f0)) / (a * a)
        lin = lin1 + f1 * f1 * np.sinc(k * f1) - f0 * f0 * np.sinc(k * f0)
    # k = 0: \int f df = (f1^2 - f0^2)/2
    lin[:, 0] = (f1[:, 0] ** 2 - f0[:, 0] ** 2) / 2.0
    b += np.sum(weight[:, None] * slope * lin, axis=0)

    from scipy.linalg import hankel, toeplitz

    Q = 0.5 * (toeplitz(q[: m + 1]) + hankel(q[: m + 1], q[m:]))
    try:
        a_coef = np.linalg.solve(Q, b)
    except np.linalg.LinAlgError:
        a_coef = np.linalg.lstsq(Q, b, rcond=None)[0]
    h = np.concatenate([a_coef[:0:-1] / 2.0, [a_coef[0]], a_coef[1:] / 2.0])
    return h


def minimum_phase(h, *, n_fft: Optional[int] = None) -> np.ndarray:
    """Minimum-phase half-length filter from linear-phase ``h``
    (scipy.signal.minimum_phase homomorphic method).

    The log-magnitude cepstrum is folded onto the causal side and
    re-exponentiated, yielding ``(len(h)+1)//2`` taps whose magnitude is
    ``sqrt(|H|)`` — the standard route to minimum-phase FIRs for low-latency
    streaming chains.  Host-side float64.
    """
    h = np.asarray(h, np.float64)
    n = len(h)
    if n_fft is None:
        n_fft = 1 << int(math.ceil(math.log2(2 * (n - 1) / 0.01)))
    if n_fft < n:
        raise ValueError(f"n_fft must be >= len(h) == {n}")
    h_spec = np.abs(np.fft.fft(h, n_fft))
    h_spec += 1e-7 * h_spec[h_spec > 0].min()  # guard exact zeros
    cep = np.fft.ifft(np.log(h_spec)).real * 0.5  # sqrt in log domain
    win = np.zeros(n_fft)
    win[0] = 1.0
    stop = (n + 1) // 2
    win[1:stop] = 2.0
    if n % 2:
        win[stop] = 1.0
    h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (n + 1) // 2
    return h_min[:n_out]


# ---------------------------------------------------------------------------
# Filtering (device-side, f32 default)
# ---------------------------------------------------------------------------


def default_nfft(ntaps: int) -> int:
    """Overlap-save FFT size: next power of two ≥ 4·ntaps (≥75% of each
    block yields valid output; 1024 taps → nfft 4096, 3072 valid/block)."""
    return 1 << max(8, math.ceil(math.log2(4 * max(ntaps, 2))))


def ols_hop(ntaps: int, nfft: int) -> int:
    """Valid samples per overlap-save block.

    The raw hop ``nfft − ntaps + 1`` is usually LCM-hostile (1024 taps →
    3073 = 7·439), which wrecks chain streaming granularity.  We round it
    down to a multiple of 512 (or the largest power of two below it) and
    zero-pad the taps to fill the block — same filter, friendlier grid.
    """
    raw = nfft - ntaps + 1
    if raw <= 0:
        raise ValueError(f"nfft={nfft} too small for ntaps={ntaps}")
    g = 512
    while g > raw:
        g //= 2
    return (raw // g) * g


def block2_block(ntaps: int) -> int:
    """Block size for method="block2": smallest multiple of 128 ≥ ntaps−1."""
    return max(128, 128 * (-(-(ntaps - 1) // 128)))


def fir_method_auto(ntaps: int) -> str:
    """The ``method="auto"`` choice: ``direct`` for short filters, ``ols``
    for long ones, on every backend (the GPU choice is unmeasured; see
    ROADMAP A4)."""
    return "direct" if ntaps <= 128 else "ols"


def band_k(ntaps: int, block: int) -> int:
    """Contraction-band width per 128-column output tile of the block2
    Toeplitz pair.

    Output column i of W = [[B],[A]] is W[m, i] = h[block + i − m],
    nonzero only for m ∈ [block+i−ntaps+1, block+i] — an ntaps-row band.
    A 128-column tile therefore touches ntaps+127 rows; aligned to a
    128-row grid that is ``block + 128 − 128·⌊(block−ntaps+1)/128⌋``
    (= 1152 for the 1024-tap/1024-block case).
    """
    return block + 128 - 128 * ((block - ntaps + 1) // 128)


def fir_state_len(ntaps: int, nfft: Optional[int] = None, method: str = "ols") -> int:
    """Length of the streaming history ``zi``/``zf`` for fir_filter."""
    if method in ("direct", "im2col"):
        return ntaps - 1
    if method == "block2":
        return block2_block(ntaps)
    nfft = nfft or default_nfft(ntaps)
    return nfft - ols_hop(ntaps, nfft)


def fir_halo(ntaps: int) -> int:
    """Samples of left-neighbour history a shard needs (overlap-save halo)."""
    return ntaps - 1


def _frame_strided(x: jnp.ndarray, nfft: int, hop: int, nframes: int) -> jnp.ndarray:
    """Frame (B, T) → (B, nframes, nfft) with given hop — gather-free.

    Built from ``ceil(nfft/hop)`` shifted hop-block reshapes concatenated
    along the last axis (no gather: the shifted-reshape form lowers to
    plain strided copies that fuse).
    Requires ``len(x) ≥ (nframes-1+ceil(nfft/hop))·hop`` — callers pad.
    """
    b = x.shape[0]
    nblk = -(-nfft // hop)
    need = (nframes - 1 + nblk) * hop
    if x.shape[1] < need:
        x = jnp.pad(x, ((0, 0), (0, need - x.shape[1])))
    parts = [
        x[:, e * hop : (e + nframes) * hop].reshape(b, nframes, hop)
        for e in range(nblk)
    ]
    return jnp.concatenate(parts, axis=-1)[:, :, :nfft]


def _ols_filter(x: jnp.ndarray, taps: jnp.ndarray, nfft: int, hist: int) -> jnp.ndarray:
    """Overlap-save on (B, T+hist) pre-padded input → (B, T) output.

    ``hist = nfft - hop ≥ ntaps-1`` history samples are already prepended;
    taps are zero-padded up to ``hist+1`` so each block's first ``hist``
    outputs are circular wrap-around to discard.
    """
    from llzlab_tpu.ops import transform as _tf

    hop = nfft - hist
    b, tp = x.shape
    t = tp - hist
    nframes = -(-t // hop)  # ceil
    pad_tail = hist + nframes * hop - tp
    xp = jnp.pad(x, ((0, 0), (0, pad_tail)))
    frames = _frame_strided(xp, nfft, hop, nframes)  # (B, F, nfft)
    H = _tf.rfft(taps.astype(jnp.float32), nfft)  # (nfft//2+1,)
    spec = _tf.rfft(frames, nfft)
    y = _tf.irfft(spec * H, nfft)
    y = y[:, :, hist:]  # discard circular wrap-around
    return y.reshape(b, nframes * hop)[:, :t].astype(x.dtype)


def _im2col_filter(x: jnp.ndarray, tap_mat: jnp.ndarray, block: int) -> jnp.ndarray:
    """Direct convolution as one dense Toeplitz matmul on pre-padded input.

    ``x (B, T + ntaps−1)`` (history prepended) → ``(B, T)``.  Each block of
    ``block`` outputs consumes a slab of ``block + ntaps − 1`` inputs;
    slabs are built from shifted hop-block reshapes (no gather) and run
    as ``(B·nblk, slab) @ (slab, block)``.
    """
    slab = tap_mat.shape[0]
    ntaps = slab - block + 1
    b, tp = x.shape
    t = tp - (ntaps - 1)
    nblk = -(-t // block)
    nsub = -(-slab // block)
    need = (nsub - 1 + nblk) * block
    xp = jnp.pad(x, ((0, 0), (0, max(0, need - tp))))
    parts = [
        xp[:, e * block : (e + nblk) * block].reshape(b, nblk, block)
        for e in range(nsub)
    ]
    slabs = jnp.concatenate(parts, axis=-1)[:, :, :slab]
    y = jnp.einsum(
        "bns,sj->bnj", slabs, tap_mat,
        preferred_element_type=jnp.float32,
        precision=_matmul_precision(),
    )
    return y.reshape(b, nblk * block)[:, :t]


def _block2_filter(x: jnp.ndarray, A: jnp.ndarray, Bm: jnp.ndarray,
                   block: int) -> jnp.ndarray:
    """Direct convolution as two square Toeplitz matmuls per block.

    ``x (B, block + T)`` (one full block of history prepended) → ``(B, T)``.
    With ``block ≥ ntaps − 1`` every output in block ``j`` depends only on
    input blocks ``j`` and ``j−1``:

        y_j = x_j @ A + x_{j−1} @ Bm,
        A[m, i]  = h[i − m]        (lower-triangular half),
        Bm[m, i] = h[block + i − m] (upper-triangular half).

    Unlike the im2col slab (which materialises a 2× duplicated copy of the
    signal through a concatenate), both operands here are plain shifted
    reshapes of the same padded buffer — zero-copy slices that XLA fuses
    into the two matmuls.
    """
    b, tp = x.shape
    t = tp - block
    nblk = -(-t // block)
    need = (nblk + 1) * block
    xp = jnp.pad(x, ((0, 0), (0, need - tp))) if need > tp else x
    cur = xp[:, block:].reshape(b, nblk, block)
    prev = xp[:, : nblk * block].reshape(b, nblk, block)
    kw = dict(preferred_element_type=jnp.float32,
              precision=_matmul_precision())
    y = (jnp.einsum("bnm,mi->bni", cur, A, **kw)
         + jnp.einsum("bnm,mi->bni", prev, Bm, **kw))
    return y.reshape(b, nblk * block)[:, :t]


@functools.lru_cache(maxsize=16)
def _block2_cached(taps_bytes: bytes, block: int):
    taps = np.frombuffer(taps_bytes, np.float64)
    ntaps = len(taps)
    if block < ntaps - 1:
        raise ValueError(f"block2 needs block ≥ ntaps−1 ({block} < {ntaps - 1})")
    A = np.zeros((block, block), np.float32)
    Bm = np.zeros((block, block), np.float32)
    i = np.arange(block)
    for m in range(block):
        k = i - m  # h index for the current block
        sel = (k >= 0) & (k < ntaps)
        A[m, sel] = taps[k[sel]]
        k2 = block + i - m  # h index reaching back into the previous block
        sel2 = (k2 >= 0) & (k2 < ntaps)
        Bm[m, sel2] = taps[k2[sel2]]
    with jax.ensure_compile_time_eval():
        return jnp.asarray(A), jnp.asarray(Bm)


@functools.partial(jax.jit, static_argnames=("block", "return_zf"))
def _fir_filter_block2_impl(x, A, Bm, zi, *, block: int, return_zf: bool):
    """Direct FIR via the two-matmul Toeplitz path (_block2_filter)."""
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if zi is None:
        hist = jnp.zeros((b, block), jnp.float32)
    else:
        hist = zi.reshape(b, block).astype(jnp.float32)
    xpad = jnp.concatenate([hist, xb.astype(jnp.float32)], axis=-1)
    y = _block2_filter(xpad, A, Bm, block).astype(x.dtype)
    y = y.reshape(shape)
    if not return_zf:
        return y
    zf = xpad[:, -block:].astype(x.dtype).reshape(shape[:-1] + (block,))
    return y, zf


@functools.lru_cache(maxsize=16)
def _toeplitz_cached(taps_bytes: bytes, block: int):
    taps = np.frombuffer(taps_bytes, np.float64)
    ntaps = len(taps)
    slab = block + ntaps - 1
    m = np.zeros((slab, block), np.float32)
    for j in range(block):
        m[j : j + ntaps, j] = taps[::-1]
    with jax.ensure_compile_time_eval():
        return jnp.asarray(m)


def _toeplitz_matrix(taps: np.ndarray, block: int):
    return _toeplitz_cached(taps.astype(np.float64).tobytes(), block)


def _direct_filter(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Direct convolution on pre-padded (B, T+ntaps-1) input via XLA conv."""
    ntaps = taps.shape[0]
    lhs = x[:, None, :]  # (B, C=1, T+ntaps-1)
    # conv_general_dilated computes correlation; flip for convolution.
    rhs = taps[::-1].astype(x.dtype)[None, None, :]  # (O=1, I=1, ntaps)
    out = lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding=[(0, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=_matmul_precision(),  # GPU f32 default is 1-pass TF32
    )
    return out[:, 0, :].astype(x.dtype)


@functools.partial(
    jax.jit, static_argnames=("method", "nfft", "hlen", "return_zf")
)
def _fir_filter_impl(x, taps, zi, *, method: str, nfft: int, hlen: int,
                     return_zf: bool):
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if zi is None:
        hist = jnp.zeros((b, hlen), dtype=x.dtype)
    else:
        hist = zi.reshape(b, hlen).astype(x.dtype)
    xpad = jnp.concatenate([hist, xb], axis=-1)
    if method == "ols":
        y = _ols_filter(xpad, taps, nfft, hlen)
    else:
        y = _direct_filter(xpad, taps)
    y = y.reshape(shape)
    if not return_zf:
        return y
    zf = xpad[:, -hlen:].reshape(shape[:-1] + (hlen,))
    return y, zf


@functools.partial(jax.jit, static_argnames=("nfft", "hlen", "return_zf"))
def _fir_filter_fused_impl(x, tables, zi, *, nfft: int, hlen: int,
                           return_zf: bool):
    """Overlap-save via the fused spectral matmul path (ols_matmul)."""
    from llzlab_tpu.ops import ols_matmul as _om

    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if zi is None:
        hist = jnp.zeros((b, hlen), dtype=jnp.float32)
    else:
        hist = zi.reshape(b, hlen).astype(jnp.float32)
    xpad = jnp.concatenate([hist, xb.astype(jnp.float32)], axis=-1)
    y = _om.ols_filter_matmul(xpad, tables, nfft, hlen).astype(x.dtype)
    y = y.reshape(shape)
    if not return_zf:
        return y
    zf = xpad[:, -hlen:].astype(x.dtype).reshape(shape[:-1] + (hlen,))
    return y, zf


@functools.partial(jax.jit, static_argnames=("hlen", "block", "return_zf"))
def _fir_filter_im2col_impl(x, tap_mat, zi, *, hlen: int, block: int,
                            return_zf: bool):
    """Direct FIR via the dense Toeplitz-matmul path (_im2col_filter)."""
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if zi is None:
        hist = jnp.zeros((b, hlen), dtype=jnp.float32)
    else:
        hist = zi.reshape(b, hlen).astype(jnp.float32)
    xpad = jnp.concatenate([hist, xb.astype(jnp.float32)], axis=-1)
    y = _im2col_filter(xpad, tap_mat, block).astype(x.dtype)
    y = y.reshape(shape)
    if not return_zf:
        return y
    zf = xpad[:, -hlen:].astype(x.dtype).reshape(shape[:-1] + (hlen,))
    return y, zf


def fir_filter(
    x: jnp.ndarray,
    taps,
    *,
    method: str = "auto",
    nfft: Optional[int] = None,
    zi: Optional[jnp.ndarray] = None,
    return_zf: bool = False,
    spectral: str = "auto",
):
    """Causal FIR filtering ``y[n] = Σ_k taps[k]·x[n-k]`` along the last axis.

    Args:
      x: ``(..., T)`` signal (any float dtype; compute is f32).
      taps: ``(ntaps,)`` filter taps (numpy or jax array).
      method: "ols" (overlap-save fast conv), "direct" (XLA conv),
        "block2" / "im2col" (Toeplitz matmuls), or "auto" (direct for
        short filters, ols for long ones).
      nfft: overlap-save FFT size; default ``default_nfft(ntaps)``.
      zi: optional ``(..., ntaps-1)`` initial history (oldest first);
        zeros if omitted.
      return_zf: also return the final history for streaming continuation.

    Streaming invariant: ``fir_filter(concat(a, b)) ==
    concat(ya, yb)`` where ``ya, zf = fir_filter(a, return_zf=True)`` and
    ``yb = fir_filter(b, zi=zf)`` — exact when len(a) is a multiple of
    ``ols_hop(ntaps, nfft)`` (frame grids coincide), ≥140 dB otherwise.
    The ``zi``/``zf`` history length is ``fir_state_len(ntaps, nfft,
    method)``.

    ``spectral`` selects the overlap-save spectral engine: "fused" is the
    single-linear-map matmul path (ols_matmul.py), "fft" the generic
    rfft→⊙H→irfft path, "auto" the fft path (unmeasured against fused
    on the GPU, ROADMAP A4).  Fused needs host-concrete taps.  Note the
    bit-exact-at-hop streaming guarantee applies to the "fft" engine;
    "fused" goes through batched matmuls whose accumulation can shift by
    an ulp with batch shape, so its split invariance is ≥140 dB.
    """
    taps_host = None
    if not isinstance(taps, jax.core.Tracer):
        taps_host = np.asarray(jax.device_get(taps), np.float64)
    taps = jnp.asarray(taps, dtype=jnp.float32)
    ntaps = taps.shape[0]
    if method == "auto":
        method = fir_method_auto(ntaps)
    if method not in ("ols", "direct", "im2col", "block2"):
        raise ValueError(f"unknown method {method!r}")
    if nfft is None:
        nfft = default_nfft(ntaps)
    if nfft < 2 * ntaps:
        raise ValueError(f"nfft={nfft} too small for ntaps={ntaps}")
    if method == "block2":
        if taps_host is None:
            raise ValueError("method='block2' needs host-concrete taps")
        block = block2_block(ntaps)
        A, Bm = _block2_cached(taps_host.tobytes(), block)
        return _fir_filter_block2_impl(
            x, A, Bm, zi, block=block, return_zf=return_zf
        )
    if method == "im2col":
        if taps_host is None:
            raise ValueError("method='im2col' needs host-concrete taps")
        tap_mat = _toeplitz_matrix(taps_host, 256)
        return _fir_filter_im2col_impl(
            x, tap_mat, zi, hlen=ntaps - 1, block=256, return_zf=return_zf
        )
    if method == "direct":
        return _fir_filter_impl(
            x, taps, zi, method="direct", nfft=nfft, hlen=ntaps - 1,
            return_zf=return_zf,
        )

    if spectral not in ("auto", "fused", "fft"):
        raise ValueError(f"unknown spectral engine {spectral!r}")
    hlen = nfft - ols_hop(ntaps, nfft)
    if spectral == "auto":
        spectral = "fft"  # fused stays opt-in (ROADMAP A4)
    hop = nfft - hlen
    fused_ok = (
        taps_host is not None
        and nfft & (nfft - 1) == 0
        and nfft >= 64
        and hop % 2 == 0
        and hlen % 2 == 0
    )
    if spectral == "fused" and fused_ok:
        from llzlab_tpu.ops.ols_matmul import ols_tables

        tb = ols_tables(taps_host, nfft)
        return _fir_filter_fused_impl(
            x, tb, zi, nfft=nfft, hlen=hlen, return_zf=return_zf
        )
    taps = jnp.pad(taps, (0, hlen + 1 - ntaps))
    return _fir_filter_impl(
        x, taps, zi, method="ols", nfft=nfft, hlen=hlen, return_zf=return_zf
    )
