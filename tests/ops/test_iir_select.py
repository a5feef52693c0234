"""SNR-guardrail IIR engine front door (ops/iir_select.py)."""

import numpy as np
import pytest
import scipy.signal as ss

import llzlab_tpu as lz
from llzlab_tpu.ops.iir_select import (
    SNR_MARGIN_DB,
    calib_path,
    load_engine_matrix,
    sosfilt_auto,
)


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    return 10 * np.log10(np.sum(ref**2) / np.sum((ref - y) ** 2))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(5).standard_normal((2, 48000)).astype(
        np.float32
    )


@pytest.fixture(scope="module")
def sos_eq():
    return lz.peaking_eq_sos(
        [100, 300, 700, 1500, 3000, 6000, 10000, 15000],
        [3, -4, 2, 5, -3, 4, -2, 3], 48000, q=1.0)


class TestSosfiltAuto:
    def test_meets_requested_snr(self, x, sos_eq):
        ref = ss.sosfilt(np.asarray(sos_eq, np.float64),
                         x[0].astype(np.float64))
        for req in (80.0, 120.0):
            y = sosfilt_auto(sos_eq, x, min_snr_db=req)
            assert y.shape == x.shape
            assert _snr(ref, y[0]) > req

    def test_bit_exact_carry_split_invariance(self, x, sos_eq):
        cut = 5 * 4096  # bit-exactness holds at block_size multiples
        full, _ = sosfilt_auto(sos_eq, x, bit_exact_carry=True,
                               return_zf=True, block_size=4096)
        a, zf = sosfilt_auto(sos_eq, x[:, :cut], bit_exact_carry=True,
                             return_zf=True, block_size=4096)
        b = sosfilt_auto(sos_eq, x[:, cut:], bit_exact_carry=True,
                         zi=zf, block_size=4096)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(a), np.asarray(b)], axis=-1),
            np.asarray(full),
        )

    def test_unreachable_snr_raises(self, x, sos_eq):
        with pytest.raises(ValueError, match="exceeds every engine"):
            sosfilt_auto(sos_eq, x, min_snr_db=200.0, bit_exact_carry=False)

    def test_state_interchange_with_engines(self, x, sos_eq):
        # zf from auto (scan on CPU) must be a valid zi for both engines.
        t = x.shape[-1]
        _, zf = sosfilt_auto(sos_eq, x[:, : t // 2], return_zf=True)
        y1 = lz.sosfilt(sos_eq, x[:, t // 2:], zi=zf)
        y2 = lz.sosfilt_matmul(sos_eq, x[:, t // 2:], zi=zf)
        ref = ss.sosfilt(np.asarray(sos_eq, np.float64),
                         x[0].astype(np.float64))[t // 2:]
        assert _snr(ref, np.asarray(y1)[0]) > 110.0
        assert _snr(ref, np.asarray(y2)[0]) > 110.0

    def test_fallback_matrix_sane(self):
        # Unknown device kind → the scan-only fallback.
        load_engine_matrix.cache_clear()
        m = load_engine_matrix("made-up-chip-9000")
        for (_eng, _prec), (msps, floor) in m.items():
            assert msps > 0 and 0 < floor < 140


class TestCalibrationArtifact:
    """Selection obeys the per-device-kind measurement artifact (no
    hard-coded constants)."""

    def test_artifact_overrides_fallback(self, tmp_path, monkeypatch):
        import json

        monkeypatch.setenv("LLZ_CALIB_DIR", str(tmp_path))
        load_engine_matrix.cache_clear()
        art = {
            "device_kind": "GPU v99",
            "measured": [
                {"engine": "matmul", "precision": "high",
                 "msps": 9000.0, "snr": 91.0},
                {"engine": "scan", "precision": "f32",
                 "msps": 250.0, "snr": 136.0},
            ],
        }
        p = calib_path("GPU v99")
        assert p.startswith(str(tmp_path))
        with open(p, "w") as f:
            json.dump(art, f)
        m = load_engine_matrix("GPU v99")
        assert m[("matmul", "high")] == (9000.0, 91.0 - SNR_MARGIN_DB)
        assert m[("scan", "f32")] == (250.0, 136.0 - SNR_MARGIN_DB)
        # floors derive from the artifact, not from any constant table
        assert ("matmul", "highest") not in m
        load_engine_matrix.cache_clear()

    def test_missing_artifact_falls_back(self, tmp_path, monkeypatch):
        monkeypatch.setenv("LLZ_CALIB_DIR", str(tmp_path))
        load_engine_matrix.cache_clear()
        m = load_engine_matrix("GPU v100")
        assert ("scan", "f32") in m  # fallback matrix
        load_engine_matrix.cache_clear()


class TestCalibArtifactShape:
    """The calibration artifact must be measured at the SAME workload
    shape the config-3 bench rows use — the artifact's speed column
    ranks engines in sosfilt_auto, and a measurement at another block
    size ranks them on the wrong shape."""

    CONFIG3_BLOCK = (2 * 48000 // 4096) * 4096  # bench/all_configs.py t3
    CONFIG3_CHANNELS = 64

    def test_packaged_artifacts_record_the_config_shape(self):
        from bench import sweep

        rows = [{"engine": "scan", "precision": "f32", "snr": 136.0,
                 "msps": 250.0, "spread_pct": 2.0, "scan_iters": 8}]
        art = sweep.calib_record("NVIDIA H100 80GB HBM3",
                                 sweep.IIR_CHANNELS, sweep.IIR_BLOCK, rows)
        # the workload string is exactly what --write-calib measured …
        assert art["workload"] == (
            "8-section peaking-EQ cascade, "
            f"{art['channels']}ch x {art['block']}")
        # … and the shape is the config-3 row's spec shape
        assert art["block"] == self.CONFIG3_BLOCK
        assert art["channels"] == self.CONFIG3_CHANNELS
        assert art["measured"] == rows
        # rankings must come from compute-dominated walls: the writer
        # refuses a row with >= 10% run-to-run spread
        noisy = [dict(rows[0], spread_pct=12.0)]
        with pytest.raises(ValueError, match="spread"):
            sweep.calib_record("x", 64, self.CONFIG3_BLOCK, noisy)
