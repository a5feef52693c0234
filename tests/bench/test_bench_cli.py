"""The measuring scripts refuse to run without a GPU unless told --cpu:
a CPU number is never printed under a device metric."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("script", ["bench.py", "bench/all_configs.py",
                                    "bench/sweep.py"])
def test_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""
