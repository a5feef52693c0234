"""Tensor-parallel FIR: filter taps split across devices (SURVEY.md §2d TP).

For very long filters the taps themselves are sharded: device k owns tap
segment ``[k·P, (k+1)·P)``, convolves the (replicated) signal with its
segment delayed by ``k·P``, and the partial products are ``psum``-reduced
over the ``tap`` axis.  Only worthwhile when ntaps is large enough that
tap-segment FLOPs dominate the broadcast of x — provided for capability
parity with TP; the channel/time sharding (sharded_ops.py) is the
production path for audio-scale filters.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from llzlab_tpu.ops import fir as _fir
from llzlab_tpu.parallel.mesh import TIME_AXIS

__all__ = ["fir_filter_tap_parallel"]


def fir_filter_tap_parallel(
    x: jnp.ndarray,
    taps,
    mesh,
    *,
    axis_name: str = TIME_AXIS,
    method: str = "ols",
) -> jnp.ndarray:
    """Causal FIR with taps sharded over ``axis_name``; x replicated.

    y = Σ_k delay(x, k·P) * seg_k, reduced with one psum.  Output matches
    ``ops.fir_filter`` ≥140 dB (partial-sum order differs).
    """
    taps = np.asarray(taps, np.float64)
    n_shards = mesh.shape[axis_name]
    ntaps = len(taps)
    seg = -(-ntaps // n_shards)
    taps_p = np.pad(taps, (0, seg * n_shards - ntaps))
    segs = taps_p.reshape(n_shards, seg)  # static per-shard tap table

    def local(x_l):
        k = lax.axis_index(axis_name)
        seg_taps = jnp.asarray(segs.astype(np.float32))[k]
        # delay x by k·P: shift right, zero-fill (causal history).
        delayed = _delay(x_l, k * seg)
        part = _fir_with_traced_taps(delayed, seg_taps)
        return lax.psum(part, axis_name)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(),  # replicated input
        out_specs=P(),
        check_vma=False,
    )
    return fn(x)


def _delay(x: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Right-shift along the last axis by traced ``d``, zero-filled."""
    t = x.shape[-1]
    idx = jnp.arange(t)
    src = idx - d
    gathered = jnp.take(x, jnp.clip(src, 0, t - 1), axis=-1)
    return jnp.where(src >= 0, gathered, 0.0)


def _fir_with_traced_taps(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Direct causal FIR where taps are a traced array (conv on matrix-unit)."""
    shape = x.shape
    xb = x.reshape(-1, shape[-1])
    ntaps = taps.shape[0]
    lhs = jnp.pad(xb, ((0, 0), (ntaps - 1, 0)))[:, None, :]
    rhs = taps[::-1].astype(xb.dtype)[None, None, :]
    out = lax.conv_general_dilated(
        lhs, rhs, (1,), [(0, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return out[:, 0, :].reshape(shape)
