"""chip_smoke.py refuses to report a result without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_check_device_refuses_cpu():
    import jax
    import chip_smoke
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.check_device(jax.devices("cpu"))


def _run(script_dir):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_chip_smoke_fails_on_cpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and r.stdout.strip() == ""
