"""Pallas GPU kernels (SURVEY.md layer T1), Triton route.

Each kernel has a jnp reference path in ``llzlab_tpu.ops`` and is
validated against it in tests/kernels/ (the Pallas interpreter on the
CPU).
"""
