"""Seeded synthetic competition input, for runs where the dataset is absent.

write_competition_input() lays out what `precompute`, `train` and `predict`
read: train.csv (ID,Target), test.csv (ID), and one 1 s, 16 kHz PCM16 wav
per row under train/ and test/, named as the dataset names them (a train ID
carries an _E_ or _I_ fragment that its wav name drops).

Each clip is noise band-limited to a random band whose position depends on
the label (exhale lower, inhale higher, with overlap), under a smooth
breath-like envelope, so a model can learn the label but not trivially.
The same seed always writes the same bytes.
"""
from __future__ import annotations

import os
import wave

import numpy as np

SR = 16_000
# (low, high) ranges of the band's centre in Hz, per label
_CENTRES = {"E": (250.0, 900.0), "I": (600.0, 1800.0)}


def synth_clips(labels, rng: np.random.Generator, sr: int = SR) -> np.ndarray:
    """One second of label-dependent band-limited noise per label ->
    int16 [N, sr]."""
    n = len(labels)
    spec = np.fft.rfft(rng.standard_normal((n, sr)), axis=-1)
    freqs = np.fft.rfftfreq(sr, 1.0 / sr)
    lo = np.array([_CENTRES[t][0] for t in labels])
    hi = np.array([_CENTRES[t][1] for t in labels])
    centre = rng.uniform(lo, hi)
    width = centre * rng.uniform(0.3, 0.8, n)
    gain = np.exp(-0.5 * ((freqs[None, :] - centre[:, None])
                          / (0.5 * width[:, None])) ** 2)
    y = np.fft.irfft(spec * gain, n=sr, axis=-1)
    t = np.arange(sr) / sr
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t[None, :] + phase)
    y = y * env
    y *= rng.uniform(0.05, 0.3, (n, 1)) / np.maximum(
        np.sqrt(np.mean(y * y, axis=-1, keepdims=True)), 1e-12)
    return np.clip(np.round(y * 32767.0), -32768, 32767).astype(np.int16)


def _write_wav(path: str, samples: np.ndarray, sr: int = SR) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.astype("<i2").tobytes())


def write_competition_input(root: str, n_train: int = 1280,
                            n_test: int = 256, seed: int = 0) -> None:
    """Write the seeded dataset under root (train.csv, test.csv, train/,
    test/). Labels alternate E/I, so each class has half the train rows."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    train_labels = ["E" if i % 2 else "I" for i in range(n_train)]
    test_labels = list(rng.choice(["E", "I"], n_test))
    train_pcm = synth_clips(train_labels, rng)
    test_pcm = synth_clips(test_labels, rng)
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("ID,Target\n")
        for i, t in enumerate(train_labels):
            f.write(f"synth_{t}_{i:05d},{t}\n")
            _write_wav(os.path.join(root, "train", f"synth_{i:05d}.wav"),
                       train_pcm[i])
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("ID\n")
        for i in range(n_test):
            name = f"synth_test_{i:05d}"
            f.write(f"{name}\n")
            _write_wav(os.path.join(root, "test", f"{name}.wav"),
                       test_pcm[i])
