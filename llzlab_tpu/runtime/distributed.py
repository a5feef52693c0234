"""Multi-host bootstrap: jax.distributed + global mesh + global arrays.

SURVEY.md layer T0 / §2e: NVLink carries the collectives between the
cards of one host, the network those between hosts (DCN);
``jax.distributed.initialize`` wires the processes together and every
jit over a global mesh emits the right transport automatically.  The
local fake-DCN fixture (scripts/multihost_fir_demo.py) runs N CPU
processes on one machine — same process boundaries, no interconnect
performance.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from llzlab_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS

__all__ = [
    "init_distributed",
    "global_dsp_mesh",
    "host_local_shard",
    "make_global_array",
    "process_index",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise multi-process JAX.  Arguments default to the standard
    env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)
    so launchers only need to set the environment."""
    kw = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"]
        )
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"]
        )
    if process_id is not None or os.environ.get("JAX_PROCESS_ID") is not None:
        kw["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"]
        )
    jax.distributed.initialize(**kw)


def process_index() -> int:
    return jax.process_index()


def global_dsp_mesh(
    n_channel: Optional[int] = None, n_time: Optional[int] = None
) -> Mesh:
    """(channel, time) mesh over ALL processes' devices.  Default: time
    axis spans everything (halo = nearest neighbour; DCN only at the one
    host boundary per ring hop)."""
    devs = np.asarray(jax.devices())
    n = devs.size
    if n_channel is None and n_time is None:
        n_channel, n_time = 1, n
    elif n_channel is None:
        n_channel = n // n_time
    elif n_time is None:
        n_time = n // n_channel
    if n_channel * n_time != n:
        raise ValueError(f"{n_channel}x{n_time} != {n} devices")
    return Mesh(devs.reshape(n_channel, n_time), (CHANNEL_AXIS, TIME_AXIS))


def host_local_shard(
    c: int, t: int, mesh: Mesh
) -> Tuple[slice, slice]:
    """The (channel, time) slice of the global (c, t) signal this process
    owns under P(channel, time) — for loading per-host input."""
    spec = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
    # Use addressable device 0's shard as the canonical host slice.
    idx = spec.addressable_devices_indices_map((c, t))
    slices = list(idx.values())
    ch = min(s[0].start or 0 for s in slices), max(
        s[0].stop or c for s in slices
    )
    tm = min(s[1].start or 0 for s in slices), max(
        s[1].stop or t for s in slices
    )
    return slice(*ch), slice(*tm)


def make_global_array(
    global_shape: Tuple[int, ...],
    mesh: Mesh,
    spec: P,
    fill_local,
) -> jax.Array:
    """Build a global array from per-device local data.

    ``fill_local(index_tuple) -> np.ndarray`` produces the block for a
    given global index (called once per addressable device).
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(global_shape, sharding, fill_local)
