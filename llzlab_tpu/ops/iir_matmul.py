"""Biquad-cascade filtering as dense triangular matmuls.

The parallel-scan sosfilt (ops/iir.py) is elementwise work: an
associative scan over 2×2 transitions.  This engine moves the recurrence
onto matrix products (BASELINE.json:5 "IIR biquad cascades re-expressed
as parallel-scan" — here the scan *is* a matmul).

Design (per section, blocks of ``L`` samples):

1. Block end-states are a matvec against the last row of the power matrix:
   ``e[j] = Σ_m p^{L−1−m}·x[j,m]`` — two ``(B·nblk, L)·(L,)`` dots.
2. The cross-block carry ``w_in[j] = e'[j−1] + p^L·w_in[j−1]`` is a
   log-depth ``associative_scan`` over blocks (cheap: one scalar complex
   per block per channel).
3. ONE matmul per section produces the output directly: the block input
   augmented with the two carry columns, times a host-built ``(L+2, L)``
   matrix that folds the whole affine map

       y[n] = b0·x[n] + c1·Re w[n−1] + c2·Im w[n−1],
       w[n−1] = Σ_{m≤n−1} p^{n−1−m} x[m] + p^n·w_in,

   i.e. ``Y[m, n] = b0·δ[m,n] + c1·Re p^{n−1−m} + c2·Im p^{n−1−m}`` plus
   two carry rows ``c1·Re p^n + c2·Im p^n`` (and the imag pairing).  No
   intermediate state arrays ever touch HBM — per section the traffic is
   ~3 reads of x + 1 write of y.

Companion-form (real-pole) sections use the same structure with powers of
the 2×2 transition.  All powers are built in float64 on host.

Numerics: powers decay (|p| < 1 for stable sections), each output sums
≤ L+3 f32 terms at HIGHEST precision — measured ≥135 dB vs the float64
serial reference on the BASELINE.json:9 8-section EQ (more accurate than
the f32 scan engine).  Streaming split invariance is ulp-level (matmul
reassociation), not bit-exact; use the scan engine when BASELINE.json:9
bit-matched carry is required.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from llzlab_tpu.ops.iir import section_realization
from llzlab_tpu.ops.transform import matmul_precision as _matmul_precision
from llzlab_tpu.ops.transform import prec_enum

__all__ = ["sosfilt_matmul"]


@functools.lru_cache(maxsize=64)
def _coupled_tables(alpha: float, beta: float, c1: float, c2: float,
                    b0: float, L: int):
    """Host-built f64→f32 tables for one coupled-form section."""
    p = complex(alpha, beta)
    pw = p ** np.arange(L + 1)  # p^0 .. p^L
    n = np.arange(L)
    # Y[m, n]: coefficient of x[m] in y[n] (within-block part).
    d = n[None, :] - 1 - n[:, None]  # n−1−m
    Y = np.where(d >= 0, c1 * pw[np.clip(d, 0, L)].real
                 + c2 * pw[np.clip(d, 0, L)].imag, 0.0)
    Y[n, n] += b0
    # Carry rows: y[n] += (c1·Re + c2·Im)(p^n · (w_r + j·w_i)).
    row_r = c1 * pw[:L].real + c2 * pw[:L].imag       # multiplies w_in_r
    row_i = -c1 * pw[:L].imag + c2 * pw[:L].real      # multiplies w_in_i
    Yaug = np.concatenate([Y, row_r[None, :], row_i[None, :]], axis=0)
    # End-state rows: e[j] = Σ_m p^(L−1−m)·x[j,m].
    erow = pw[L - 1 - n]
    with jax.ensure_compile_time_eval():
        return (
            jnp.asarray(Yaug.astype(np.float32)),          # (L+2, L)
            jnp.asarray(erow.real.astype(np.float32)),     # (L,)
            jnp.asarray(erow.imag.astype(np.float32)),     # (L,)
            jnp.asarray(np.array([pw[L].real, pw[L].imag], np.float32)),
            jnp.asarray(
                np.stack([pw[1:].real, pw[1:].imag], 0).astype(np.float32)
            ),                                             # (2, L): p^(n+1)
        )


@functools.lru_cache(maxsize=64)
def _companion_tables(a1: float, a2: float, b0: float, b1: float, b2: float,
                      L: int):
    """Host-built tables for one companion-form (real poles) section."""
    A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    B = np.array([b1 - a1 * b0, b2 - a2 * b0], np.float64)
    pw = np.empty((L + 1, 2, 2), np.float64)
    pw[0] = np.eye(2)
    for k in range(1, L + 1):
        pw[k] = A @ pw[k - 1]
    n = np.arange(L)
    d = n[None, :] - 1 - n[:, None]  # n−1−m
    eb = pw @ B  # (L+1, 2): A^k B
    # y[n] = b0·x[n] + s1[n−1];  s1[n−1] = Σ_{m≤n−1} [A^(n−1−m)B]_0 x[m]
    #        + [A^n s_in]_0.
    Y = np.where(d >= 0, eb[np.clip(d, 0, L), 0], 0.0)
    Y[n, n] += b0
    row_s1 = pw[:L, 0, 0]  # multiplies s_in[0]
    row_s2 = pw[:L, 0, 1]  # multiplies s_in[1]
    Yaug = np.concatenate([Y, row_s1[None, :], row_s2[None, :]], axis=0)
    erow = eb[L - 1 - n]  # (L, 2): coefficient of x[j,m] in e[j]
    with jax.ensure_compile_time_eval():
        return (
            jnp.asarray(Yaug.astype(np.float32)),
            jnp.asarray(erow[:, 0].astype(np.float32)),
            jnp.asarray(erow[:, 1].astype(np.float32)),
            jnp.asarray(pw[L].astype(np.float32)),         # A^L (2,2)
            jnp.asarray(pw[1:].transpose(1, 2, 0).astype(np.float32)),
            # (2, 2, L): A^(n+1) for the ragged-tail zf matvec
        )


def _carry_scan_complex(er, ei, s0, pL):
    """w_end[j] = e[j] + p^L·w_end[j−1] with w_end[−1] = s0 → returns the
    carry ENTERING each block (w_end[j−1])."""
    b, nblk = er.shape
    er = er.at[:, 0].add(pL[0] * s0[:, 0] - pL[1] * s0[:, 1])
    ei = ei.at[:, 0].add(pL[0] * s0[:, 1] + pL[1] * s0[:, 0])

    def combine(left, right):
        ar_l, ai_l, ur_l, ui_l = left
        ar_r, ai_r, ur_r, ui_r = right
        ar = ar_r * ar_l - ai_r * ai_l
        ai = ar_r * ai_l + ai_r * ar_l
        ur = ar_r * ur_l - ai_r * ui_l + ur_r
        ui = ar_r * ui_l + ai_r * ur_l + ui_r
        return ar, ai, ur, ui

    a_r = jnp.full((b, nblk), pL[0], jnp.float32)
    a_i = jnp.full((b, nblk), pL[1], jnp.float32)
    _, _, we_r, we_i = lax.associative_scan(
        combine, (a_r, a_i, er, ei), axis=1
    )
    win_r = jnp.concatenate([s0[:, :1], we_r[:, :-1]], axis=1)
    win_i = jnp.concatenate([s0[:, 1:2], we_i[:, :-1]], axis=1)
    return win_r, win_i, we_r, we_i


def _carry_scan_mat(e, s0, AL):
    """Same as above for the 2-state companion recurrence."""
    b, nblk, _ = e.shape
    e = e.at[:, 0, :].add(jnp.einsum("id,bd->bi", AL, s0,
                                     precision=jax.lax.Precision.HIGHEST))

    def combine(left, right):
        m_l, u_l = left
        m_r, u_r = right
        m = jnp.einsum("...ij,...jk->...ik", m_r, m_l,
                       precision=jax.lax.Precision.HIGHEST)
        u = jnp.einsum("...ij,...j->...i", m_r, u_l,
                       precision=jax.lax.Precision.HIGHEST) + u_r
        return m, u

    m_elems = jnp.broadcast_to(AL, (b, nblk, 2, 2))
    _, s_end = lax.associative_scan(combine, (m_elems, e), axis=1)
    s_in = jnp.concatenate([s0[:, None, :], s_end[:, :-1, :]], axis=1)
    return s_in, s_end


def _out_matmul(xaug, Yaug, prec):
    """The per-section (B, nblk, L+2) @ (L+2, L) output matmul.

    An explicit 2-way-bf16-split compensated product ("bf16x4") was
    tried here and retired: a two-bf16 split carries only 16 mantissa
    bits, and it lost to both HIGH and HIGHEST on speed and SNR.
    """
    return jnp.einsum("bjm,mn->bjn", xaug, Yaug, precision=prec,
                      preferred_element_type=jnp.float32)


def _coupled_section(x, s0, tables, L, t, prec):
    """x (B, Tp) padded to a multiple of L; returns (y (B, Tp), zf (B, 2))."""
    Yaug, er_row, ei_row, pL, qpow = tables
    b, tp = x.shape
    nblk = tp // L
    xb = x.reshape(b, nblk, L)
    kw = dict(preferred_element_type=jnp.float32, precision=prec)
    # Carry path stays HIGHEST regardless of `prec`: the end-state dots
    # feed every later block through the scan, so precision error here
    # would compound across the whole stream, while they cost only 1/L of
    # the output matmul's FLOPs.  (Measured: the [high] 84.7 dB ceiling is
    # set by the OUTPUT matmul's bf16x3 rounding, not the carries — the
    # pin protects long streams, it does not lift that ceiling.)
    kw_c = dict(preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    er = jnp.einsum("bjm,m->bj", xb, er_row, **kw_c)
    ei = jnp.einsum("bjm,m->bj", xb, ei_row, **kw_c)
    win_r, win_i, we_r, we_i = _carry_scan_complex(er, ei, s0, pL)
    xaug = jnp.concatenate(
        [xb, win_r[..., None], win_i[..., None]], axis=-1
    )  # (B, nblk, L+2)
    y = _out_matmul(xaug, Yaug, prec).reshape(b, tp)
    # zf = w[t−1]: end-state of the block containing t−1 when t is at a
    # block edge, else one small matvec on that block.
    jstar, nstar = (t - 1) // L, (t - 1) % L
    if nstar == L - 1:
        zf = jnp.stack([we_r[:, jstar], we_i[:, jstar]], -1)
    else:
        # w[t−1] = Σ_{m≤n*} p^(n*−m) x[j*,m] + p^(n*+1)·w_in[j*]
        coef_r = er_row[L - 1 - nstar:]  # p^(n*−m), m = 0..n*  (reversed tail)
        coef_i = ei_row[L - 1 - nstar:]
        xs = xb[:, jstar, : nstar + 1]
        wr = jnp.einsum("bm,m->b", xs, coef_r, **kw_c) \
            + qpow[0, nstar] * win_r[:, jstar] - qpow[1, nstar] * win_i[:, jstar]
        wi = jnp.einsum("bm,m->b", xs, coef_i, **kw_c) \
            + qpow[0, nstar] * win_i[:, jstar] + qpow[1, nstar] * win_r[:, jstar]
        zf = jnp.stack([wr, wi], -1)
    return y, zf


def _companion_section(x, s0, tables, L, t, prec):
    Yaug, e1_row, e2_row, AL, qpow = tables
    b, tp = x.shape
    nblk = tp // L
    xb = x.reshape(b, nblk, L)
    kw = dict(preferred_element_type=jnp.float32, precision=prec)
    kw_c = dict(preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)  # carry path: see above
    e1 = jnp.einsum("bjm,m->bj", xb, e1_row, **kw_c)
    e2 = jnp.einsum("bjm,m->bj", xb, e2_row, **kw_c)
    s_in, s_end = _carry_scan_mat(jnp.stack([e1, e2], -1), s0, AL)
    xaug = jnp.concatenate([xb, s_in], axis=-1)  # (B, nblk, L+2)
    y = _out_matmul(xaug, Yaug, prec).reshape(b, tp)
    jstar, nstar = (t - 1) // L, (t - 1) % L
    if nstar == L - 1:
        zf = s_end[:, jstar, :]
    else:
        xs = xb[:, jstar, : nstar + 1]
        s1 = jnp.einsum("bm,m->b", xs, e1_row[L - 1 - nstar:], **kw_c)
        s2 = jnp.einsum("bm,m->b", xs, e2_row[L - 1 - nstar:], **kw_c)
        loc = jnp.stack([s1, s2], -1)
        zf = loc + jnp.einsum("id,bd->bi", qpow[..., nstar],
                              s_in[:, jstar, :],
                              precision=jax.lax.Precision.HIGHEST)
    return y, zf


def _factory(kinds, L: int, return_zf: bool, t: int, prec):
    @jax.jit
    def run(x, tables, zi_b):
        shape = x.shape
        xb = x.reshape(-1, t).astype(jnp.float32)
        tp = t + ((-t) % L)
        cur = jnp.pad(xb, ((0, 0), (0, tp - t)))
        zf = []
        for s, kind in enumerate(kinds):
            fn = _coupled_section if kind == "coupled" else _companion_section
            cur, z = fn(cur, zi_b[:, s, :], tables[s], L, t, prec)
            if return_zf:
                zf.append(z)
        y = cur[:, :t].reshape(shape).astype(x.dtype)
        if not return_zf:
            return y
        return y, jnp.stack(zf, 1).reshape(shape[:-1] + (len(kinds), 2))

    return run


@functools.lru_cache(maxsize=256)
def _run_cached(kinds, L, return_zf, t, prec):
    return _factory(kinds, L, return_zf, t, prec)


def sosfilt_matmul(
    sos,
    x: jnp.ndarray,
    *,
    zi: Optional[jnp.ndarray] = None,
    block_size: int = 254,
    return_zf: bool = False,
    precision: Optional[str] = None,
):
    """Matmul biquad cascade (drop-in for :func:`llzlab_tpu.sosfilt`).

    Default ``block_size=254`` makes the per-section contraction
    K = L+2 = 256, a whole number of matrix tiles (MACs/sample = L+2
    grows with L, so longer blocks cost more).

    Same state convention as sosfilt (``(..., ns, 2)`` in the per-section
    scan realization), so states interchange between engines.  Prefer the
    scan engine for bit-matched
    streaming splits (BASELINE.json:9).

    ``precision`` ("highest" | "high" | "default") overrides the global
    LLZ_MATMUL_PRECISION for THIS call's output matmuls; the cross-block
    carry path is always HIGHEST (cheap, and bf16x3 error there compounds
    across the stream).  Use :func:`llzlab_tpu.ops.iir_select.sosfilt_auto`
    to pick engine+precision from a required SNR.
    """
    sos_np = np.asarray(sos, dtype=np.float64)
    if sos_np.ndim != 2 or sos_np.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos_np.shape}")
    kinds = []
    tables = []
    L = int(block_size)
    for row in sos_np:
        kind, prm = section_realization(row)
        kinds.append(kind)
        if kind == "coupled":
            alpha, beta, c1, c2, b0 = (float(v) for v in prm)
            tables.append(_coupled_tables(alpha, beta, c1, c2, b0, L))
        else:
            b0, b1, b2, _, a1, a2 = (float(v) for v in row)
            tables.append(_companion_tables(a1, a2, b0, b1, b2, L))
    t = int(x.shape[-1])
    prec = _matmul_precision() if precision is None else prec_enum(precision)
    run = _run_cached(tuple(kinds), L, bool(return_zf), t, prec)
    nb = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    ns = sos_np.shape[0]
    if zi is None:
        zi_b = jnp.zeros((nb, ns, 2), dtype=jnp.float32)
    else:
        zi_b = jnp.asarray(zi).reshape(nb, ns, 2).astype(jnp.float32)
    return run(x, tuple(tables), zi_b)
