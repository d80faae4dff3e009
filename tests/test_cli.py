"""CLI surface tests: parser wiring, reference back-compat, config overrides."""
import argparse

import pytest

from tpu_breath.cli import build_parser
from tpu_breath.config import CNN8_TRAIN, VGG_TRAIN, TrainCfg, Paths


def test_subcommands_exist():
    p = build_parser()
    for cmd in ("precompute", "train", "predict", "e2e"):
        args = p.parse_args([cmd])
        assert args.cmd == cmd


def test_legacy_precompute_flag():
    p = build_parser()
    args = p.parse_args(["--precompute"])
    assert args.precompute and args.cmd is None


def test_train_flags():
    p = build_parser()
    a = p.parse_args(["train", "--archs", "vgg", "--epochs", "7", "--fused",
                      "--seed", "3", "--resume", "--root", "/data"])
    assert a.archs == "vgg" and a.epochs == 7 and a.fused and a.seed == 3
    assert a.resume and a.root == "/data"


def test_orchestrator_hyperparams_match_reference():
    # reference src/scripts.py:19-34 (CNN8) and :38-46 (VGG uses defaults, D5)
    assert (CNN8_TRAIN.num_epochs, CNN8_TRAIN.base_lr) == (100, 4e-4)
    assert (CNN8_TRAIN.cutmix_prob, CNN8_TRAIN.mixup_prob) == (0.6, 0.4)
    assert (CNN8_TRAIN.patience, CNN8_TRAIN.warmup_epochs) == (25, 4)
    assert (VGG_TRAIN.num_epochs, VGG_TRAIN.patience) == (140, 55)
    d = TrainCfg()
    assert (VGG_TRAIN.base_lr, VGG_TRAIN.cutmix_prob, VGG_TRAIN.mixup_prob,
            VGG_TRAIN.warmup_epochs) == (d.base_lr, d.cutmix_prob,
                                         d.mixup_prob, d.warmup_epochs)


def test_paths_single_root():
    p = Paths(root="data")
    assert p.precomputed_dir.startswith("data")
    assert p.feature_cache.startswith("data")
    assert p.train_csv == "data/train.csv"


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_choice(env_set, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the program sets
    nothing; without it, the cache goes to the fixed <checkout>/.cache/jax."""
    import os

    import jax
    from tpu_breath.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "jax"))
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    try:
        got = compile_cache.configure()
        if env_set:
            assert got == str(tmp_path / "jax")
            assert jax.config.jax_compilation_cache_dir == before
        else:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".cache", "jax")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_BLOCKED_RUN = """
import sys
for name in ("flax", "orbax", "pandas", "sklearn", "rich"):
    sys.modules[name] = None
from tpu_breath import cli
root, out = sys.argv[1], sys.argv[2]
cli.main(["precompute", "--root", root, "--chunk", "8"])
cli.main(["train", "--root", root, "--out-root", out, "--archs", "cnn8",
          "--epochs", "1", "--batch-size", "4", "--mesh", "off", "--predict"])
cli.main(["predict", "--root", root, "--out-root", out, "--archs", "cnn8"])
for name in ("flax", "orbax", "pandas", "sklearn", "rich"):
    assert sys.modules[name] is None, name
"""


def test_cli_runs_without_optional_packages(tmp_path):
    """precompute -> train -> predict through cli.main at full feature width
    with flax, orbax, pandas, sklearn and rich unimportable: the main path
    needs only JAX and the packages every install has."""
    import os
    import subprocess
    import sys

    from tpu_breath.data import dataset as ds, synth

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root, out = tmp_path / "input", tmp_path / "out"
    synth.write_competition_input(str(root), n_train=10, n_test=3, seed=0)
    env = {**os.environ, "PYTHONPATH": repo, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(root),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    sub = ds.read_table(str(out / "submissions" / "submission.csv"))
    assert len(sub["ID"]) == 3 and set(sub["Target"]) <= {"E", "I"}
