"""DSP device mesh: named axes ('channel', 'time') (SURVEY.md §2d-e).

The reference is serial C (no threads/processes/devices) — parallelism is
a first-class component of this framework, not a port.  Channels are
embarrassingly parallel (channel-DP, no steady-state communication); time
is sequence-parallel (time-SP) with overlap-save halos and filter-state
carries between neighbouring shards (BASELINE.json:5).  The mesh follows
the algorithm alone: on one host the cards reach each other all to all
(NVLink), so any placement of the axes costs the same; across hosts
``channel`` is the outer axis, where the slower links are tolerable.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_dsp_mesh",
    "channel_time_spec",
    "CHANNEL_AXIS",
    "TIME_AXIS",
]

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_dsp_mesh(
    n_channel: Optional[int] = None,
    n_time: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(channel, time)`` mesh over ``devices`` (default: all).

    With only a device count available, the split favours the time axis
    (halo traffic is small; channel-DP needs none, so any factorisation
    is communication-optimal — time-major keeps single-channel streams
    scalable).
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    n = len(devs)
    if n_channel is None and n_time is None:
        n_time = _largest_pow2_factor(n)
        n_channel = n // n_time
    elif n_channel is None:
        n_channel = n // n_time
    elif n_time is None:
        n_time = n // n_channel
    if n_channel * n_time > n:
        raise ValueError(
            f"mesh {n_channel}x{n_time} needs more than {n} devices"
        )
    # An explicit smaller shape uses a prefix of the devices.
    arr = np.asarray(devs[: n_channel * n_time]).reshape(n_channel, n_time)
    return Mesh(arr, (CHANNEL_AXIS, TIME_AXIS))


def _largest_pow2_factor(n: int) -> int:
    f = 1
    while n % (2 * f) == 0:
        f *= 2
    return f


def channel_time_spec() -> P:
    """PartitionSpec for a ``(channels, time)`` signal block."""
    return P(CHANNEL_AXIS, TIME_AXIS)
