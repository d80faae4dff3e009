"""make_epoch_runner (whole-epoch lax.scan) must match the per-step path."""
import numpy as np
import jax
import jax.numpy as jnp

from tpu_breath.config import TrainCfg
from tpu_breath.models.cnn8 import CNN8
from tpu_breath.train.loop import (create_state, make_epoch_runner,
                                   make_train_step)


def test_epoch_scan_matches_per_step():
    rng = np.random.default_rng(0)
    n, b = 32, 16
    f = jnp.asarray(rng.standard_normal((n, 9, 16, 8)).astype(np.float32))
    s = jnp.asarray(rng.standard_normal((n, 36)).astype(np.float32))
    l = jnp.asarray((np.arange(n) % 2).astype(np.float32))
    cfg = TrainCfg(num_epochs=2, batch_size=b, warmup_epochs=0)  # aug ON
    model = CNN8(num_scalar_features=36, dropout_rate=0.0, dtype=jnp.float32)
    idx = jnp.arange(n).reshape(2, b)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    use_aug = jnp.asarray(True)

    state_a, tx_a, _ = create_state(model, jax.random.PRNGKey(0), cfg, 2)
    runner = make_epoch_runner(model, tx_a, cfg)
    st_a, stats_a = runner(state_a, f, s, l, idx, keys, use_aug)
    stats_a = jax.device_get(stats_a)

    state_b, tx_b, _ = create_state(model, jax.random.PRNGKey(0), cfg, 2)
    step = make_train_step(model, tx_b, cfg)
    st_b = state_b
    losses, accs = [], []
    for i in range(2):
        st_b, st = step(st_b, f, s, l, idx[i], keys[i], use_aug)
        losses.append(float(st["loss"]))
        accs.append(float(st["acc"]))

    np.testing.assert_allclose(np.asarray(stats_a["loss"]), losses, atol=1e-5)
    np.testing.assert_allclose(np.asarray(stats_a["acc"]), accs, atol=1e-6)
    pa = np.concatenate([np.asarray(x).ravel()
                         for x in jax.tree.leaves(st_a.params)])
    pb = np.concatenate([np.asarray(x).ravel()
                         for x in jax.tree.leaves(st_b.params)])
    assert np.max(np.abs(pa - pb)) < 5e-5
