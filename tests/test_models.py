"""Model-zoo contract tests: shapes, parameter budgets, BN/dropout behavior.

Mirrors the reference's published parameter counts (~2.43M CNN8 / ~8.15M VGG
with 39 scalars; slightly less with the true 36 — SURVEY.md §2.5 D2)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpu_breath.models.cnn8 import CNN8
from tpu_breath.models.vgg import VGG
from tpu_breath.models import registry


def _init(model, b=4):
    feats = jnp.zeros((b, 9, 128, 63), jnp.float32)
    scals = jnp.zeros((b, 36), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0))
    return variables, feats, scals


def _n_params(params):
    return sum(x.size for x in jax.tree.leaves(params))


def test_cnn8_shape_and_params():
    model = CNN8(num_scalar_features=36)
    variables, feats, scals = _init(model)
    n = _n_params(variables["params"])
    # reference quotes ~2.43M with 39 scalars (README.md:133); 36 gives
    # marginally fewer
    assert 2.3e6 < n < 2.5e6, n
    out, _ = jax.jit(lambda v, f, s: model.apply(v, f, s, train=False))(
        variables, feats, scals)
    assert out.shape == (4,)
    assert out.dtype == jnp.float32


def test_vgg_shape_and_params():
    model = VGG(num_scalar_features=36)
    variables, feats, scals = _init(model)
    n = _n_params(variables["params"])
    # reference quotes ~8.15M (paper/sections/method.tex:91)
    assert 7.9e6 < n < 8.4e6, n
    out, _ = jax.jit(lambda v, f, s: model.apply(v, f, s, train=False))(
        variables, feats, scals)
    assert out.shape == (4,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_batch_stats_update_only_in_train_mode():
    model = CNN8(num_scalar_features=36)
    variables, feats, scals = _init(model)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.standard_normal(feats.shape), jnp.float32)

    def apply(v, f, s, train):
        return model.apply(v, f, s, train=train, key=jax.random.PRNGKey(2))

    apply = jax.jit(apply, static_argnums=3)
    before = jax.tree.leaves(variables["batch_stats"])
    _, stats = apply(variables, feats, scals, True)
    after = jax.tree.leaves(stats)
    assert any(not np.allclose(b, a) for b, a in zip(before, after))
    _, stats = apply(variables, feats, scals, False)
    for b, a in zip(before, jax.tree.leaves(stats)):
        np.testing.assert_array_equal(b, a)


def test_eval_is_deterministic_train_is_stochastic():
    model = VGG(num_scalar_features=36)
    variables, feats, scals = _init(model)
    rng = np.random.default_rng(1)
    feats = jnp.asarray(rng.standard_normal(feats.shape), jnp.float32)

    ev = jax.jit(lambda v, f, s: model.apply(v, f, s, train=False)[0])
    a = np.asarray(ev(variables, feats, scals))
    b = np.asarray(ev(variables, feats, scals))
    np.testing.assert_array_equal(a, b)

    tr = jax.jit(lambda v, f, s, k: model.apply(v, f, s, train=True,
                                                key=k)[0])
    x = np.asarray(tr(variables, feats, scals, jax.random.PRNGKey(3)))
    y = np.asarray(tr(variables, feats, scals, jax.random.PRNGKey(4)))
    assert not np.array_equal(x, y)


def test_registry():
    assert set(registry.ARCHS) == {"cnn8", "vgg"}
    with pytest.raises(ValueError):
        registry.build("nope", 36)
