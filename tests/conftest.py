"""Test environment.

The suite runs on the CPU with 8 virtual devices, so mesh and sharding paths
are testable on one host. Tests marked `gpu` need the card: they are
selected with `python -m pytest -m gpu tests/`, which leaves the platform to
JAX, and they skip with a reason wherever no GPU is present.
"""
import os

import numpy as np
import pytest
import wave


def pytest_configure(config):
    # Runs before any test module (and so JAX) is imported. The default run
    # stays on the CPU; only the card-only selection may see the GPU.
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        # the CLI's persistent compile cache is for the card's programs
        os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip where this host has none (decided here, at
    run time, never while test modules are imported)."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/` on "
                    "the card")


@pytest.fixture(scope="session")
def cpu_device():
    import jax
    return jax.devices("cpu")[0]


REFERENCE_WAVS = "/root/reference/input/test"


def load_wav(path: str) -> np.ndarray:
    with wave.open(path) as w:
        assert w.getnchannels() == 1 and w.getframerate() == 16000
        data = w.readframes(w.getnframes())
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0


@pytest.fixture(scope="session")
def real_clips() -> np.ndarray:
    """A small batch of real stethoscope clips from the reference test set."""
    import glob
    paths = sorted(glob.glob(os.path.join(REFERENCE_WAVS, "*.wav")))[:4]
    if not paths:
        pytest.skip("reference wav data not available")
    return np.stack([load_wav(p)[:16000] for p in paths])


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session", autouse=True)
def build_native_decoder():
    """Build native/libwavio.so once per session when a toolchain exists, so
    the default checkout exercises the C++ decoder (threaded decode, polyphase
    resample, downmix, PCM8/16/24/32+float) instead of silently degrading to
    python-path-only coverage."""
    import shutil
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    so = os.path.join(root, "native", "libwavio.so")
    if not os.path.exists(so) and shutil.which("g++") and shutil.which("make"):
        subprocess.run(["make", "-C", os.path.join(root, "native")],
                       check=False, capture_output=True)
