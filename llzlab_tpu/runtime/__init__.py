"""Runtime bootstrap: platform, mesh, distributed init (SURVEY.md layer T0)."""

from llzlab_tpu.runtime.platform import (  # noqa: F401
    backend, cpu_mesh_devices, enable_compile_cache, force_cpu)
