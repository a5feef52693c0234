"""chip_smoke.py off the GPU: its arguments, its last line, and its
refusal to run without a GPU (or without the rest of the repository)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_one_card():
    assert chip_smoke.parse_args([]).devices == 1
    assert chip_smoke.parse_args(["--devices", "4"]).devices == 4
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--devices", "2"])


def test_result_line_format():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_requires_gpu_here():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(1)


def test_snr_and_split_note():
    a = [[1.0, 2.0, 3.0], [1.0, -1.0, 1.0]]
    assert chip_smoke.split_note(a, a) == "bit-exact"
    b = [[1.0, 2.0, 3.0001], [1.0, -1.0, 1.0]]
    assert chip_smoke.split_note(a, b).endswith("dB")
    assert 80 < chip_smoke.snr_db(a, b) < 120


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """On the CPU, from the repo or from a directory holding only the
    script, it fails and prints no result line."""
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd, script = str(tmp_path), "chip_smoke.py"
    else:
        cwd, script = ROOT, os.path.join(ROOT, "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
