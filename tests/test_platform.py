"""runtime/platform.py: the one backend decision, the compile-cache rule,
and the published-peak table every roofline divides by."""

import os

import jax
import pytest

from llzlab_tpu.runtime import platform
from llzlab_tpu.utils import profiling


class TestBackend:
    def test_cpu_here(self):
        assert platform.backend() == "cpu"

    def test_gpu_passes(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert platform.backend() == "gpu"

    @pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
    def test_refuses_other_backends(self, monkeypatch, name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        with pytest.raises(RuntimeError, match=name):
            platform.backend()

    @pytest.mark.parametrize("module", [
        "llzlab_tpu.ops.fused_chain", "llzlab_tpu.ops.transform",
        "llzlab_tpu.ops.spectral", "llzlab_tpu.ops.iir_select",
        "llzlab_tpu.chains.channelizer"])
    def test_engine_autos_route_through_backend(self, module):
        import importlib

        mod = importlib.import_module(module)
        assert mod.backend is platform.backend


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert platform.enable_compile_cache() == str(tmp_path)
        # no other directory is set in code
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_inside_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = platform.enable_compile_cache()
            assert path == platform.CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(path) == root
        with open(os.path.join(root, ".gitignore")) as f:
            assert os.path.basename(path) + "/" in f.read().split()

    def test_cpu_mesh_devices_needs_enough(self):
        assert len(platform.cpu_mesh_devices(8)) == 8
        with pytest.raises(RuntimeError, match="device_count"):
            platform.cpu_mesh_devices(4096)


class TestPeaks:
    def test_h100_row(self):
        row = profiling.CHIP_PEAKS["NVIDIA H100 80GB HBM3"]
        assert row == {"tflops_bf16": 989.0, "tflops_tf32": 495.0,
                       "tflops_f32": 67.0, "hbm_gbps": 3350.0}

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200",
                                      "NVIDIA A100-SXM4-80GB"])
    def test_unknown_kind_raises(self, kind):
        with pytest.raises(KeyError, match="no published peaks"):
            profiling.roofline_report(seconds=1.0, flops=1.0,
                                      device_kind=kind)

    def test_fractions(self):
        r = profiling.roofline_report(
            seconds=1e-3, flops=989e12 * 1e-3 / 2, bytes_moved=3.35e12 * 1e-3,
            device_kind="NVIDIA H100 80GB HBM3")
        assert r["tc_fraction_bf16"] == pytest.approx(0.5)
        assert r["hbm_fraction"] == pytest.approx(1.0)
