"""Architecture registry (the analogue of the reference's arch-string
dispatch in src/utils/ensemble.py:7-18)."""
from __future__ import annotations

from tpu_breath.models.cnn8 import CNN8
from tpu_breath.models.vgg import VGG

ARCHS = {"cnn8": CNN8, "vgg": VGG}


def build(arch: str, num_scalar_features: int, **kwargs):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch](num_scalar_features=num_scalar_features, **kwargs)
