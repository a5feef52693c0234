"""Test fixture: 8 virtual CPU devices.

All unit/parallel tests run on a simulated 8-device CPU mesh
(SURVEY.md §4.4): we (a) request 8 host devices before backends
initialise and (b) pin the platform to cpu, so a machine with a GPU
still runs the suite on its CPU.  The on-card check is chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from llzlab_tpu.runtime.platform import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# The parallel tests are dominated by shard_map compiles (~10-40 s each on
# an 8-device CPU mesh); persist them so repeated suite runs are cache hits.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def snr_db(ref, y) -> float:
    """Signal-to-error ratio in dB (the SURVEY.md §4 acceptance metric)."""
    ref = np.asarray(ref, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    err = ref - y
    perr = float(np.sum(np.abs(err) ** 2))
    psig = float(np.sum(np.abs(ref) ** 2))
    if perr == 0.0:
        return float("inf")
    return 10.0 * np.log10(psig / perr)


@pytest.fixture(scope="session")
def snr():
    return snr_db
