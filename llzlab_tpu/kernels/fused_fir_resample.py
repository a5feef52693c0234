"""Pallas (Triton route) kernel: fused FIR + polyphase-resample step.

Implements the composite engine's contract (``ops/fused_chain.py``): the
same ``(nparts, down, up)`` weight blocks from :func:`fir_resample_tables`
and the same ``hist_len`` input history, so it is a drop-in behind
``fir_resample(engine="pallas")`` and streams interchangeably with
``engine="composite"``.

    z[b, s, p] = Σ_e Σ_d xs[b, (s+e)·down + d] · G[e, d, p],
    xs = concat(history, x, zeros)

The XLA composite evaluates this as ``nparts`` shifted einsums, each with
its own slice of the input and its own pass over the ``(b, s, up)``
accumulator in device memory.  Here one program owns a ``(bm, bn)`` tile
of output groups × phases of one channel and keeps the accumulator in
registers: it loops over the parts and over ``bk``-wide chunks of
``down``, loading ``x`` rows straight from device memory (the overlap
between parts is served from L1/L2) and reading the history where the
window reaches before ``x[0]``, so no concatenated copy is materialised.

Precision: a plain float32 ``pl.dot`` runs in single-pass TF32 on this
route, far below 80 dB on the headline chain.  ``"high"`` splits the
input tile and the weights into bfloat16 ``(hi, lo)`` pieces and sums
three tensor-core products (lo·hi + hi·lo + hi·hi).  ``"highest"`` asks
Triton for its three-pass TF32 product (``TF32_TF32_F32_X3``), which
measured well above a hand-written TF32 split (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from llzlab_tpu.ops.resample import resample_output_len

__all__ = ["fused_fir_resample_pallas", "kernel_tables"]

#: tile sizes: output groups per program, K chunk of ``down``, phases
#: per program, and the Triton launch shape (chosen on an H100: PERF.md)
BM, BK, BN = 64, 32, 64
NUM_WARPS, NUM_STAGES = 4, 3

#: tiers; "highest" runs one float32 product with this algorithm on the GPU
#: (the CPU interpreter has no TF32 and computes it in float32)
_TF32X3 = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
TIERS = ("high", "highest")


def _split(v):
    """``v`` (f32) as bfloat16 ``(hi, lo)`` with ``hi + lo ≈ v``."""
    hi = v.astype(jnp.bfloat16)
    return hi, (v - hi.astype(jnp.float32)).astype(jnp.bfloat16)


def _tile_k(down: int) -> int:
    return BK if down >= BK else 16


def _tile_n(up: int) -> int:
    return BN if up >= BN else max(16, 1 << (up - 1).bit_length())


def kernel_tables(gparts, mode: str):
    """The composite weights ``gparts (nparts, down, up)`` as the kernel
    reads them: ``(hi, lo)`` bfloat16 pieces for ``"high"``, one float32
    table for ``"highest"``; each ``(nparts·down_p/bk, bk, up_p)`` with
    ``down`` and ``up`` zero-padded to the tile sizes."""
    if mode not in TIERS:
        raise ValueError(f"unknown precision mode {mode!r}")
    g = np.asarray(gparts, np.float64)
    nparts, down, up = g.shape
    bk, bn = _tile_k(down), _tile_n(up)
    down_p = -(-down // bk) * bk
    up_p = -(-up // bn) * bn
    g = np.pad(g, ((0, 0), (0, down_p - down), (0, up_p - up)))
    g = g.reshape(nparts * (down_p // bk), bk, up_p)
    with jax.ensure_compile_time_eval():
        if mode == "highest":
            return (jnp.asarray(g.astype(np.float32)),)
        hi = g.astype(np.float32).astype(jnp.bfloat16)
        lo = (g - np.asarray(hi, np.float64)).astype(np.float32).astype(
            jnp.bfloat16)
        return jnp.asarray(hi), jnp.asarray(lo)


def _kernel(x_ref, h_ref, *refs, t, hist_len, down, up, n_out, nk, nparts,
            bm, bk, bn, mode, interpret):
    w_refs, o_ref = refs[:-1], refs[-1]
    prec = jax.lax.Precision.HIGHEST if interpret else _TF32X3
    s0 = pl.program_id(1) * bm
    n0 = pl.program_id(2) * bn
    rows = s0 + jnp.arange(bm, dtype=jnp.int32)
    cols = jnp.arange(bk, dtype=jnp.int32)
    ragged_k = nk * bk != down

    def body(j, acc):
        e = jax.lax.div(j, nk)
        k0 = jax.lax.rem(j, nk) * bk
        pos = (rows[:, None] + e) * down + k0 + cols[None, :]
        q = pos - hist_len
        in_win = (k0 + cols[None, :] < down) if ragged_k else True
        xv = plt.load(x_ref.at[q],
                      mask=(q >= 0) & (q < t) & in_win, other=0.0)
        hv = plt.load(h_ref.at[pos],
                      mask=(q < 0) & in_win, other=0.0)
        w = [r[j, :, pl.ds(n0, bn)] for r in w_refs]
        if mode == "highest":
            return acc + pl.dot(xv + hv, w[0], precision=prec)
        a_hi, a_lo = _split(xv + hv)
        # smallest products first; the dropped lo·lo term is below the
        # pieces' rounding
        for a, w_ in ((a_lo, w[0]), (a_hi, w[1]), (a_hi, w[0])):
            acc = acc + pl.dot(a, w_)
        return acc

    acc = jax.lax.fori_loop(0, nparts * nk, body,
                            jnp.zeros((bm, bn), jnp.float32))
    phase = n0 + jnp.arange(bn, dtype=jnp.int32)
    idx = rows[:, None] * up + phase[None, :]
    plt.store(o_ref.at[idx], acc,
              mask=(phase[None, :] < up) & (idx < n_out))


@functools.partial(jax.jit, static_argnames=("up", "down", "hist_len",
                                             "return_zf", "mode",
                                             "interpret"))
def _fused_jit(x, zi, tables, *, up, down, hist_len, return_zf, mode,
               interpret):
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).astype(jnp.float32)
    b = xb.shape[0]
    if zi is None:
        hist = jnp.zeros((b, hist_len), jnp.float32)
    else:
        hist = zi.reshape(b, hist_len).astype(jnp.float32)
    n_out = resample_output_len(t, up, down)
    s_groups = -(-t // down)
    bk, bn = _tile_k(down), _tile_n(up)
    nk = -(-down // bk)
    nparts = tables[0].shape[0] // nk
    bm = BM
    kern = functools.partial(
        _kernel, t=t, hist_len=hist_len, down=down, up=up, n_out=n_out,
        nk=nk, nparts=nparts, bm=bm, bk=bk, bn=bn, mode=mode,
        interpret=interpret)
    row = lambda c, s, n: (c, 0)
    whole = lambda c, s, n: (0, 0, 0)
    z = pl.pallas_call(
        kern,
        grid=(b, -(-s_groups // bm), tables[0].shape[-1] // bn),
        in_specs=[
            pl.BlockSpec((None, t), row),
            pl.BlockSpec((None, hist_len), row),
            *[pl.BlockSpec(w.shape, whole) for w in tables],
        ],
        out_specs=pl.BlockSpec((None, n_out), row),
        out_shape=jax.ShapeDtypeStruct((b, n_out), jnp.float32),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="fused_fir_resample",
    )(xb, hist, *tables)
    z = z.reshape(shape[:-1] + (n_out,)).astype(x.dtype)
    if not return_zf:
        return z
    zf = jnp.concatenate([hist, xb], axis=-1)[:, -hist_len:]
    return z, zf.astype(x.dtype).reshape(shape[:-1] + (hist_len,))


def fused_fir_resample_pallas(x, tables, hist_len: int, up: int,
                              down: int, *, zi=None, return_zf: bool = False,
                              interpret: bool = False):
    """Fused FIR→resample of ``x (..., T)`` with ``zi (..., hist_len)``
    history, ``tables`` from :func:`kernel_tables` (its tier follows
    from them; see
    :func:`llzlab_tpu.ops.fused_chain.fir_resample_tables`).

    ``interpret`` runs the Pallas interpreter (CPU tests only)."""
    mode = "highest" if len(tables) == 1 else "high"
    return _fused_jit(x, zi, tuple(tables), up=up, down=down,
                      hist_len=hist_len, return_zf=return_zf, mode=mode,
                      interpret=interpret)
