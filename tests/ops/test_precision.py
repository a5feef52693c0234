"""Precision tiers: what each name means per backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import llzlab_tpu as lz
from llzlab_tpu.ops import transform as tf


@pytest.mark.parametrize("name,cpu", [
    ("highest", jax.lax.Precision.HIGHEST),
    ("high", jax.lax.Precision.HIGH),
    ("default", jax.lax.Precision.DEFAULT)])
def test_cpu_tiers(name, cpu):
    assert tf.prec_enum(name) == cpu


def test_gpu_high_is_three_pass_bf16(monkeypatch):
    # Precision.HIGH would be single-pass TF32 on the GPU (71 dB on the
    # headline chain); the tier keeps its bf16x3 meaning explicitly
    monkeypatch.setattr(tf, "backend", lambda: "gpu")
    assert tf.prec_enum("high") == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    assert tf.prec_enum("highest") == jax.lax.Precision.HIGHEST


def test_einsum_accepts_the_preset():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((16, 32)),
                    jnp.float32)
    b = jnp.asarray(np.random.default_rng(1).standard_normal((32, 8)),
                    jnp.float32)
    z = jnp.einsum("ij,jk->ik", a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3)
    np.testing.assert_allclose(np.asarray(z), np.asarray(a) @ np.asarray(b),
                               rtol=1e-4, atol=1e-4)


def test_unknown_tier_rejected(monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "fast")
    with pytest.raises(ValueError, match="highest|high|default"):
        tf.matmul_precision_name()


@pytest.mark.parametrize("prec", ["high", "highest"])
def test_iir_matmul_tiers_run(prec):
    sos = lz.peaking_eq_sos([500.0], [4.0], 48000.0)
    x = np.random.default_rng(2).standard_normal((2, 1024)).astype(
        np.float32)
    y = lz.sosfilt_matmul(sos, x, precision=prec)
    ref = lz.sosfilt(sos, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=1e-4)
