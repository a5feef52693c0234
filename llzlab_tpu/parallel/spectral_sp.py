"""Time-sharded STFT → spectral gain → iSTFT (config 4 over the mesh).

Each time shard owns the frames *starting* inside its range.  Analysis
needs ``n_fft − hop`` lookahead from the right neighbour (one ppermute);
synthesis OLA produces a tail that overlaps the right neighbour's head,
sent right and added (second ppermute), together with the window-square
envelope so the WOLA division stays exact at shard boundaries.  Interior
samples match the unsharded chain; the trailing ``n_fft − hop`` samples
of the stream see extra zero-padded frames (pure reconstruction — the
envelope divides out exactly what was added).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from llzlab_tpu.ops import spectral as _sp
from llzlab_tpu.ops import transform as _tf
from llzlab_tpu.ops.spectral import spectral_engine_auto
from llzlab_tpu.ops.window import get_window
from llzlab_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS

__all__ = ["spectral_gain_sharded"]


def _from_right(x_tail: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Receive the neighbour-to-the-right's ``x_tail``; last shard gets 0."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(
        x_tail, axis_name, [(i, i - 1) for i in range(1, n)]
    )


def _to_right(x_tail: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Send ``x_tail`` to the right neighbour; shard 0 receives 0."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(
        x_tail, axis_name, [(i, i + 1) for i in range(n - 1)]
    )


def spectral_gain_sharded(
    x: jnp.ndarray,
    gain: Union[np.ndarray, Callable],
    mesh,
    *,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window: str = "hann",
    method: str = "auto",
    engine: str = "auto",
) -> jnp.ndarray:
    """Sharded STFT→gain→iSTFT on ``x (C, T)``; returns ``(C, T)``.

    Requires ``T/n_time`` to be a multiple of ``hop``.

    ``engine``: "cwola" runs each shard's analysis→gain→synthesis as
    the ONE composed frame matmul (`ops/spectral.composed_wola`, r5 —
    static gains only; 2.0× fewer MACs, no per-shard spectrum);
    "reference" keeps the framed rfft/irfft path; "auto" resolves via
    :func:`llzlab_tpu.ops.spectral.spectral_engine_auto` — mirroring
    ``SpectralGainStage``'s resolution, so the sharded and streaming
    paths run the same engine.
    """
    hop = hop or n_fft // 4
    overlap = n_fft - hop
    nt = mesh.shape[TIME_AXIS]
    t_loc = x.shape[-1] // nt
    if x.shape[-1] % nt or t_loc % hop:
        raise ValueError(
            f"T_loc={x.shape[-1]}/{nt} must be a multiple of hop={hop}"
        )
    if engine == "auto":
        engine = spectral_engine_auto()
    if engine == "cwola" and callable(gain):
        raise ValueError("engine='cwola' needs a static gain vector")
    w_np = get_window(window, n_fft, periodic=True).astype(np.float32)
    w = jnp.asarray(w_np)
    gain_arr = None if callable(gain) else jnp.asarray(gain, jnp.float32)
    gain_f64 = (None if callable(gain)
                else np.ascontiguousarray(gain, np.float64))

    def local(x_l):
        c_loc = x_l.shape[0]
        look = _from_right(x_l[..., :overlap], TIME_AXIS)
        ext = jnp.concatenate([x_l, look], axis=-1)  # (C, T_loc+overlap)
        nf = t_loc // hop
        if engine == "cwola":
            ola = _sp.composed_wola(
                ext, jnp.ones((nf,), jnp.float32), n_fft, hop, window,
                gain_f64)  # (C, T_loc+overlap)
        else:
            frames = _sp.frame(ext, n_fft, hop) * w  # (C, F_loc, n_fft)
            spec = _tf.rfft(frames, n_fft, method=method)
            spec = spec * (gain(spec) if callable(gain) else gain_arr)
            synth = _tf.irfft(spec, n_fft, method=method) * w
            ola = _sp.overlap_add(synth, hop)  # (C, T_loc+overlap)
        env = _sp.overlap_add(
            jnp.broadcast_to(w * w, (nf, n_fft)), hop
        )  # (T_loc+overlap,)
        y_tail = _to_right(ola[..., t_loc:], TIME_AXIS)
        e_tail = _to_right(env[t_loc:], TIME_AXIS)
        y_acc = ola[..., :t_loc].at[..., :overlap].add(y_tail)
        e_acc = env[:t_loc].at[:overlap].add(e_tail)
        return (y_acc / jnp.maximum(e_acc, 1e-8)).astype(x_l.dtype)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(CHANNEL_AXIS, TIME_AXIS),
        out_specs=P(CHANNEL_AXIS, TIME_AXIS),
        check_vma=False,
    )
    return fn(x)
