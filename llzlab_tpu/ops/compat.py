"""scipy.signal-compatible front doors over the framework's engines.

Capability parity target: the reference's design/analysis entry points
(``llz_fir.c``/``llz_iir.c`` designers — mount empty, spec anchor
BASELINE.json:5) PLUS the scipy-shaped API a migrating user expects.
Everything here is a thin, TESTED adapter: the numerics live in
``ops.iir`` (f64 zpk pipeline), ``ops.convolve`` (fft convolution),
``ops.analysis`` and friends.  Functions that are pure coefficient math
(design, conversions, initial conditions) are host-side float64 numpy
by design — they run once per filter, not per sample; everything on
the signal path returns jit-able jnp ops.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops import iir as _iir
from llzlab_tpu.ops.iir import (  # noqa: F401  (re-exported)
    buttord, cheb1ord, cheb2ord, ellipord, tf2sos,
)
from llzlab_tpu.ops.convolve import fftconvolve as _fftconvolve

__all__ = [
    "butter", "cheby1", "cheby2", "ellip", "bessel", "iirfilter",
    "iirdesign",
    "bilinear_zpk", "zpk2tf", "tf2zpk", "zpk2sos", "sos2tf", "sos2zpk",
    "normalize",
    "lfiltic", "deconvolve", "freqs",
    "convolve", "oaconvolve", "upfirdn",
    "analytic_envelope", "unit_impulse", "lombscargle", "find_peaks",
    "buttord", "cheb1ord", "cheb2ord", "ellipord", "tf2sos",
]


# ---------------------------------------------------------------------------
# zpk-level design (scipy signatures)
# ---------------------------------------------------------------------------

_PROTOS = {
    "butter": lambda n, rp, rs: _iir._buttap(n),
    "cheby1": lambda n, rp, rs: _iir._cheb1ap(n, rp),
    "cheby2": lambda n, rp, rs: _iir._cheb2ap(n, rs),
    "ellip": lambda n, rp, rs: _iir._ellipap(n, rp, rs),
    "bessel": lambda n, rp, rs: _iir._besselap(n, "phase"),
}


def _design_zpk(ftype, n, wn, btype, analog, fs, rp=None, rs=None,
                proto=None):
    z, p, k = proto if proto is not None else _PROTOS[ftype](n, rp, rs)
    wn = np.atleast_1d(np.asarray(wn, np.float64))
    btype = btype.lower()
    if analog:
        if fs is not None:
            raise ValueError("fs cannot be given for analog filters")
        warped = wn
    else:
        if fs is not None:
            wn = wn * 2.0 / fs
        if np.any(wn <= 0) or np.any(wn >= 1):
            raise ValueError("digital critical frequencies must lie in "
                             "(0, 1) (Nyquist units) or (0, fs/2)")
        fs_d = 2.0
        warped = 2.0 * fs_d * np.tan(np.pi * wn / fs_d)
    if btype in ("lowpass", "low", "lp"):
        z, p, k = _iir._lp2lp(z, p, k, warped[0])
    elif btype in ("highpass", "high", "hp"):
        z, p, k = _iir._lp2hp(z, p, k, warped[0])
    elif btype in ("bandpass", "bp", "band", "pass"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _iir._lp2bp(z, p, k, wo, bw)
    elif btype in ("bandstop", "bs", "notch", "stop"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _iir._lp2bs(z, p, k, wo, bw)
    else:
        raise ValueError(f"unknown btype {btype!r}")
    if not analog:
        z, p, k = _iir._bilinear_zpk(z, p, k, 2.0)
    return z, p, float(np.real(k))


def _to_output(z, p, k, output):
    output = output.lower()
    if output == "zpk":
        return z, p, k
    if output == "sos":
        return _iir._zpk2sos(z, p, k)
    if output == "ba":
        return zpk2tf(z, p, k)
    raise ValueError(f"unknown output {output!r}")


def butter(N, Wn, btype="low", analog=False, output="ba", fs=None):
    """Butterworth design, scipy.signal.butter-compatible."""
    return _to_output(*_design_zpk("butter", N, Wn, btype, analog, fs),
                      output)


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    return _to_output(
        *_design_zpk("cheby1", N, Wn, btype, analog, fs, rp=rp), output)


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    return _to_output(
        *_design_zpk("cheby2", N, Wn, btype, analog, fs, rs=rs), output)


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    return _to_output(
        *_design_zpk("ellip", N, Wn, btype, analog, fs, rp=rp, rs=rs),
        output)


def bessel(N, Wn, btype="low", analog=False, output="ba", norm="phase",
           fs=None):
    return _to_output(
        *_design_zpk("bessel", N, Wn, btype, analog, fs,
                     proto=_iir._besselap(N, norm)),
        output)


def iirfilter(N, Wn, rp=None, rs=None, btype="band", analog=False,
              ftype="butter", output="ba", fs=None):
    """scipy.signal.iirfilter-compatible generic design."""
    return _to_output(
        *_design_zpk(ftype, N, Wn, btype, analog, fs, rp=rp, rs=rs),
        output)


_ORD = {"butter": buttord, "cheby1": cheb1ord, "cheby2": cheb2ord,
        "ellip": ellipord}


def iirdesign(wp, ws, gpass, gstop, analog=False, ftype="ellip",
              output="ba", fs=None):
    """Design from band-edge specs: minimum order via the *ord rules,
    then the corresponding designer (scipy.signal.iirdesign analog;
    analog designs are not supported — the reference lab is digital)."""
    if analog:
        raise NotImplementedError("iirdesign supports digital only")
    if ftype not in _ORD:
        raise ValueError(f"ftype {ftype!r} not supported")
    fs_eff = 2.0 if fs is None else fs
    n, wn = _ORD[ftype](wp, ws, gpass, gstop, fs=fs_eff)
    kw = {}
    if ftype in ("cheby1", "ellip"):
        kw["rp"] = gpass
    if ftype in ("cheby2", "ellip"):
        kw["rs"] = gstop
    return _to_output(
        *_design_zpk(ftype, n, wn, _iir._ord_btype(wp, ws), False, fs,
                     **kw),
        output)


# ---------------------------------------------------------------------------
# representation conversions (host-side f64)
# ---------------------------------------------------------------------------

def zpk2tf(z, p, k):
    b = np.atleast_1d(k * np.poly(np.asarray(z, complex)))
    a = np.atleast_1d(np.poly(np.asarray(p, complex)))
    if np.all(np.abs(b.imag) < 1e-12 * np.maximum(1, np.abs(b.real).max())):
        b = b.real
    if np.all(np.abs(a.imag) < 1e-12 * np.maximum(1, np.abs(a.real).max())):
        a = a.real
    return b, a


def tf2zpk(b, a):
    b, a = normalize(b, a)
    z = np.roots(b) if len(b) > 1 else np.array([])
    p = np.roots(a) if len(a) > 1 else np.array([])
    k = b[0] / a[0]
    return z, p, k


def zpk2sos(z, p, k):
    """zpk → second-order sections via the design pipeline's pairing.

    Pairing order differs from scipy's (compare frequency responses,
    not raw rows)."""
    return _iir._zpk2sos(z, p, k)


def sos2tf(sos):
    sos = np.asarray(sos, np.float64)
    b, a = np.ones(1), np.ones(1)
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    return b, a


def sos2zpk(sos):
    b, a = sos2tf(sos)
    return tf2zpk(b, a)


def normalize(b, a):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    a = np.trim_zeros(a, "f")
    if a.size == 0 or a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    return b / a[0], a / a[0]


def bilinear_zpk(z, p, k, fs):
    """Analog zpk → digital zpk via the bilinear transform
    (scipy.signal.bilinear_zpk)."""
    return _iir._bilinear_zpk(
        np.asarray(z, complex), np.asarray(p, complex), float(k),
        float(fs))


# ---------------------------------------------------------------------------
# filtering utilities
# ---------------------------------------------------------------------------

def lfiltic(b, a, y, x=None):
    """Initial conditions for :func:`llzlab_tpu.lfilter` reproducing past
    outputs ``y = [y[-1], y[-2], …]`` / inputs ``x`` (scipy.signal.lfiltic,
    direct-form II transposed)."""
    b, a = normalize(b, a)
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    y = np.asarray(y, np.float64)
    x = np.zeros(0) if x is None else np.asarray(x, np.float64)
    zi = np.zeros(n - 1)
    for m in range(n - 1):
        s = 0.0
        for i in range(m + 1, n):
            if i - m - 1 < len(x):
                s += b[i] * x[i - m - 1]
            if i - m - 1 < len(y):
                s -= a[i] * y[i - m - 1]
        zi[m] = s
    return zi


def deconvolve(signal, divisor):
    """Polynomial long division: ``signal = conv(divisor, quot) + rem``
    (scipy.signal.deconvolve, host-side f64)."""
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if den[0] == 0:
        raise ValueError("divisor[0] must be nonzero")
    if len(num) < len(den):
        return np.array([0.0]), num.copy()
    nq = len(num) - len(den) + 1
    quot = np.zeros(nq)
    rem = num.copy()
    for i in range(nq):
        quot[i] = rem[i] / den[0]
        rem[i : i + len(den)] -= quot[i] * den
    return quot, rem


def freqs(b, a, worN=200):
    """Analog transfer-function frequency response H(jω)
    (scipy.signal.freqs)."""
    if np.isscalar(worN):
        b_, a_ = normalize(b, a)
        roots = np.concatenate([
            np.roots(b_) if len(b_) > 1 else np.zeros(0),
            np.roots(a_) if len(a_) > 1 else np.zeros(0),
        ])
        mags = np.abs(roots[np.abs(roots) > 0])
        hi = 10.0 * (mags.max() if mags.size else 1.0)
        w = np.logspace(np.log10(hi) - 4, np.log10(hi), int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(np.atleast_1d(b), s) / np.polyval(np.atleast_1d(a), s)
    return w, h


# ---------------------------------------------------------------------------
# convolution family (fft path underneath)
# ---------------------------------------------------------------------------

def convolve(in1, in2, mode="full", method="auto"):
    """1-D convolution on the last axis (scipy.signal.convolve for 1-D;
    ``method`` "fft"/"auto" run the fft path, "direct" uses
    jnp.convolve)."""
    if method == "direct":
        a = jnp.asarray(in1)
        v = jnp.asarray(in2)
        if a.ndim == 1 and v.ndim == 1:
            return jnp.convolve(a, v, mode=mode)
        method = "fft"
    return _fftconvolve(jnp.asarray(in1), jnp.asarray(in2), mode=mode)


def oaconvolve(in1, in2, mode="full"):
    """Overlap-add convolution (delegates to the fft engine: one batched
    transform, so a separate OA segmentation adds nothing; semantics match
    scipy.oaconvolve 1-D)."""
    return _fftconvolve(jnp.asarray(in1), jnp.asarray(in2), mode=mode)


def upfirdn(h, x, up=1, down=1):
    """Upsample–FIR–downsample with scipy.signal.upfirdn's exact output
    length, on the fft-convolution path: zero-stuff by ``up``,
    convolve "full" with ``h``, take every ``down``-th sample."""
    x = jnp.asarray(x)
    h = jnp.asarray(h, jnp.float32 if x.dtype != jnp.float64 else x.dtype)
    n_in = x.shape[-1]
    if up > 1:
        xs = jnp.zeros(x.shape[:-1] + (n_in, up), x.dtype)
        xs = xs.at[..., 0].set(x)
        x = xs.reshape(x.shape[:-1] + (n_in * up,))
        x = x[..., : (n_in - 1) * up + 1]
    y = _fftconvolve(x, h, mode="full")
    return y[..., ::down]


# ---------------------------------------------------------------------------
# analysis utilities
# ---------------------------------------------------------------------------

def analytic_envelope(x, n: Optional[int] = None):
    """Analytic-signal amplitude envelope ``|hilbert(x)|``.

    NOT scipy.signal.envelope (which takes bp_in/n_out/residual and
    returns a stacked (2, ...) envelope+residual array) — this helper
    deliberately carries a non-scipy name so the scipy-compat surface
    stays spelling-accurate (ADVICE r3).
    """
    from llzlab_tpu.ops.analysis import hilbert

    return jnp.abs(hilbert(jnp.asarray(x), n))


def unit_impulse(shape, idx=None, dtype=np.float64):
    """scipy.signal.unit_impulse."""
    out = np.zeros(shape, dtype)
    if idx is None:
        idx = (0,) * out.ndim
    elif idx == "mid":
        idx = tuple(s // 2 for s in out.shape)
    out[idx] = 1
    return out


def lombscargle(x, y, freqs, precenter=False, normalize=False):
    """Lomb–Scargle periodogram for unevenly sampled data
    (scipy.signal.lombscargle's classic Scargle formulation).  The
    trig sums are batched outer products — they run as dense matrix-unit-friendly
    jnp reductions."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    freqs = jnp.asarray(freqs, jnp.float32)
    if precenter:
        y = y - jnp.mean(y)
    wt = freqs[:, None] * x[None, :]            # (F, N)
    s2 = jnp.sum(jnp.sin(2 * wt), axis=1)
    c2 = jnp.sum(jnp.cos(2 * wt), axis=1)
    tau_arg = 0.5 * jnp.arctan2(s2, c2)         # ω·τ
    wtt = wt - tau_arg[:, None]
    cw = jnp.cos(wtt)
    sw = jnp.sin(wtt)
    yc = cw @ y
    ys = sw @ y
    cc = jnp.sum(cw * cw, axis=1)
    ss = jnp.sum(sw * sw, axis=1)
    p = 0.5 * (yc * yc / cc + ys * ys / ss)
    if normalize:
        p = p * 2.0 / jnp.sum(y * y)
    return p


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None):
    """Local-maxima finder (scipy.signal.find_peaks subset: height,
    threshold, distance, prominence; plateaus resolve to their middle
    sample like scipy).  Peak *selection* is host-side numpy — it is
    data-dependent control flow, the part XLA cannot trace; any heavy
    math upstream of it stays on device."""
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError("find_peaks expects a 1-D signal")
    # plateau-aware local maxima (scipy's midpoint convention)
    peaks = []
    i, n = 1, len(x)
    while i < n - 1:
        if x[i - 1] < x[i]:
            if x[i + 1] < x[i]:
                peaks.append(i)
            elif x[i + 1] == x[i]:
                j = i
                while j < n - 1 and x[j + 1] == x[j]:
                    j += 1
                if j < n - 1 and x[j + 1] < x[i]:
                    peaks.append((i + j) // 2)
                i = j
        i += 1
    peaks = np.asarray(peaks, np.intp)
    props = {}

    def _minmax(interval):
        v = np.asarray(interval, np.float64)
        return (v[0], v[1]) if v.ndim else (float(v), np.inf)

    if height is not None:
        hmin, hmax = _minmax(height)
        keep = (x[peaks] >= hmin) & (x[peaks] <= hmax)
        peaks = peaks[keep]
    if threshold is not None:
        tmin, tmax = _minmax(threshold)
        left = x[peaks] - x[peaks - 1]
        right = x[peaks] - x[peaks + 1]
        t = np.minimum(left, right)
        keep = (t >= tmin) & (t <= tmax)
        peaks = peaks[keep]
    if prominence is not None or distance is not None:
        prom = _prominences(x, peaks)
    if prominence is not None:
        pmin, pmax = _minmax(prominence)
        keep = (prom >= pmin) & (prom <= pmax)
        peaks, prom = peaks[keep], prom[keep]
    if distance is not None:
        # scipy: highest peaks claim their neighbourhood first
        order = np.argsort(x[peaks])[::-1]
        keep = np.ones(len(peaks), bool)
        for idx in order:
            if not keep[idx]:
                continue
            close = np.abs(peaks - peaks[idx]) < distance
            close[idx] = False
            keep[close] = False
        peaks = peaks[keep]
    if prominence is not None:
        props["prominences"] = _prominences(x, peaks)
    if height is not None:
        props["peak_heights"] = x[peaks]
    return peaks, props


def _prominences(x, peaks):
    prom = np.zeros(len(peaks))
    for n, p in enumerate(peaks):
        h = x[p]
        # walk left until a higher sample or the border
        lo_l = h
        i = p - 1
        m = h
        while i >= 0 and x[i] <= h:
            m = min(m, x[i])
            i -= 1
        lo_l = m if i >= 0 else min(m, x[: p + 1].min())
        lo_r = h
        i = p + 1
        m = h
        while i < len(x) and x[i] <= h:
            m = min(m, x[i])
            i += 1
        lo_r = m if i < len(x) else min(m, x[p:].min())
        prom[n] = h - max(lo_l, lo_r)
    return prom
