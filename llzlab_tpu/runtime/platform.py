"""Platform helpers (SURVEY.md layer T0): which backend runs, CPU pinning
for tests, and the persistent compilation cache."""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["backend", "force_cpu", "cpu_mesh_devices", "device_kind",
           "enable_compile_cache", "CACHE_DIR"]

#: compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset
#: (inside the checkout, listed in .gitignore)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def backend() -> str:
    """``"gpu"`` or ``"cpu"``: the backend every engine choice keys on.

    Raises on any other backend — no engine table covers it."""
    name = jax.default_backend()
    if name not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: llzlab_tpu runs on an "
            "NVIDIA GPU or (tests) the CPU")
    return name


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and no other directory is set in code; otherwise the cache
    goes to :data:`CACHE_DIR` inside the checkout."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


def force_cpu(n_devices: Optional[int] = None) -> None:
    """Pin this process to the CPU backend (optionally with ``n_devices``
    virtual devices — only effective if called before jax backend init)."""
    if n_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n_devices}"
            ).strip()
    jax.config.update("jax_platforms", "cpu")


def cpu_mesh_devices(n: int = 8):
    """Devices for a simulated n-way CPU mesh (test fixture)."""
    devs = jax.devices("cpu")
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} CPU devices; start the process with "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n}"
        )
    return devs[:n]


def device_kind() -> str:
    return jax.devices()[0].device_kind
