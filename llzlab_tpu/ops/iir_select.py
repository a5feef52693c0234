"""IIR engine selection with SNR guardrails, calibrated per device kind.

Capability parity target: the reference's single serial biquad path
(``llz_iir.c``; mount empty — spec anchor BASELINE.json:9 "8-section EQ
cascade, bit-matched state carry") — which never had to choose.  This
framework has two engines with different speed/precision/exactness
contracts; this module is the one front door: callers state the SNR they
need and whether streaming splits must be bit-exact.

Engine data is MEASURED, not hard-coded.  ``bench/sweep.py --suite iir
--write-calib`` writes a per-device-kind artifact to
``llzlab_tpu/calib/<kind>.json``; :func:`load_engine_matrix` reads the
artifact for the RUNNING device kind and derives selection floors as
``measured SNR − SNR_MARGIN_DB``.  On a device kind with no artifact (no
kind has one yet) the fallback below applies: the scan engine only.

Guardrail margin: SNR depends on the cascade's pole radii and the signal
spectrum, so floors sit ``SNR_MARGIN_DB`` under the benchmark-EQ
measurement to absorb nastier filters.  (The matmul@high ceiling is set
by bf16x3 rounding compounding through the cascade — pinning the carry
path at HIGHEST did not move it, and an explicit bf16x4 compensated
product measured WORSE: 46.5 dB @ 3719 Msps, retired in round 2.)
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from llzlab_tpu.ops.iir import sosfilt
from llzlab_tpu.ops.iir_matmul import sosfilt_matmul
from llzlab_tpu.runtime.platform import backend

__all__ = ["sosfilt_auto", "load_engine_matrix", "calib_path",
           "SNR_MARGIN_DB"]

#: selection floors sit this far under the measured benchmark-EQ SNR
SNR_MARGIN_DB = 10.0

# (engine, precision) -> (Msps estimate, guaranteed SNR floor dB) used
# when the running device kind has no calibration artifact: the scan
# engine only, whose float32 recurrence needs no precision tier.  The
# matmul engine is chosen only from a measured artifact.  Its speed only
# ranks candidates; the floor is the load-bearing part.
_FALLBACK: Dict[Tuple[str, str], Tuple[float, float]] = {
    ("scan", "f32"): (1.0, 125.0),
}


def _kind_slug(device_kind: str) -> str:
    return device_kind.lower().replace(" ", "-").replace("/", "-")


def calib_path(device_kind: str) -> str:
    """Artifact path for a device kind (env ``LLZ_CALIB_DIR`` overrides
    the packaged ``llzlab_tpu/calib/`` directory — used by tests)."""
    d = os.environ.get("LLZ_CALIB_DIR")
    if d is None:
        d = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "calib")
    return os.path.join(d, _kind_slug(device_kind) + ".json")


@functools.lru_cache(maxsize=8)
def load_engine_matrix(
    device_kind: str,
) -> Dict[Tuple[str, str], Tuple[float, float]]:
    """Engine matrix for a device kind: ``(engine, precision) → (msps,
    floor_db)`` with floors = measured − :data:`SNR_MARGIN_DB`."""
    path = calib_path(device_kind)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return dict(_FALLBACK)
    out = {}
    for row in data.get("measured", []):
        key = (row["engine"], row["precision"])
        out[key] = (float(row["msps"]),
                    float(row["snr"]) - SNR_MARGIN_DB)
    return out if out else dict(_FALLBACK)


def sosfilt_auto(
    sos,
    x: jnp.ndarray,
    *,
    min_snr_db: float = 80.0,
    bit_exact_carry: bool = False,
    zi: Optional[jnp.ndarray] = None,
    return_zf: bool = False,
    block_size: Optional[int] = None,
):
    """Cascaded biquad filtering, engine picked from the caller's needs.

    Args:
      sos: ``(ns, 6)`` second-order sections (``a0 == 1``), host-concrete.
      x: ``(..., T)`` signal.
      min_snr_db: required output SNR vs the exact (float64 serial)
        response.  The fastest engine whose calibrated floor (see module
        docstring) meets it is chosen; raises ValueError if nothing can.
      bit_exact_carry: require BASELINE.json:9 bit-matched streaming
        state — splitting the stream at any block boundary and carrying
        ``zf`` must reproduce the unsplit output bit-for-bit.  Only the
        scan engine guarantees this (the matmul engine's splits are
        ulp-level); implies the scan engine regardless of speed.
      zi / return_zf / block_size: as in :func:`llzlab_tpu.sosfilt`
        (states interchange between engines — same ``(..., ns, 2)``
        realization convention).

    Returns ``y`` or ``(y, zf)``.
    """
    if bit_exact_carry:
        kw = {} if block_size is None else {"block_size": block_size}
        return sosfilt(sos, x, zi=zi, return_zf=return_zf, **kw)

    if backend() == "cpu":
        # CPU matmuls are exact f32, so the precision tiers do not exist,
        # and the scan engine wins there anyway.
        matrix = {("scan", "f32"): _FALLBACK[("scan", "f32")]}
    else:
        matrix = load_engine_matrix(jax.devices()[0].device_kind)
    max_floor = max(v[1] for v in matrix.values())
    if min_snr_db > max_floor:
        raise ValueError(
            f"min_snr_db={min_snr_db} exceeds every engine's calibrated "
            f"floor for this device kind (max {max_floor:.1f} dB); use "
            "float64 offline processing for higher accuracy"
        )
    candidates = sorted(matrix.items(), key=lambda kv: -kv[1][0])
    for (engine, prec), (_msps, floor) in candidates:
        if floor < min_snr_db:
            continue
        kw = {} if block_size is None else {"block_size": block_size}
        if engine == "matmul":
            return sosfilt_matmul(
                sos, x, zi=zi, return_zf=return_zf, precision=prec, **kw
            )
        return sosfilt(sos, x, zi=zi, return_zf=return_zf, **kw)
    raise AssertionError("unreachable: max_floor checked above")
