"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8): the full train step under data
parallelism, sharding layouts, and the driver entry points."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpu_breath.parallel import mesh as mesh_lib


def test_eight_virtual_devices():
    assert jax.device_count() >= 8


def test_dryrun_multichip_entrypoint():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (8,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_dp_matches_single_device():
    """The sharded train step must compute the same loss as single-device."""
    from tpu_breath.config import TrainCfg
    from tpu_breath.models.cnn8 import CNN8
    from tpu_breath.train.loop import create_state, make_train_step

    rng = np.random.default_rng(0)
    b = 16
    feats = jnp.asarray(rng.standard_normal((b, 9, 16, 8)), jnp.float32)
    scals = jnp.asarray(rng.standard_normal((b, 36)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 2, b), jnp.float32)
    cfg = TrainCfg(num_epochs=1, batch_size=b, warmup_epochs=99)  # aug off
    # f32 activations for this equivalence test: in bf16, near-zero gradients
    # can flip sign between reduction orders and Adam turns a sign flip into a
    # full lr step — layout equivalence is only meaningfully testable in f32
    model = CNN8(num_scalar_features=36, dropout_rate=0.0, dtype=jnp.float32)

    def run(mesh):
        state, tx, _ = create_state(model, jax.random.PRNGKey(0), cfg, steps_per_epoch=1)
        if mesh is not None:
            state = jax.device_put(state, mesh_lib.replicated(mesh))
        step = make_train_step(model, tx, cfg, mesh)
        new_state, stats = step(state, feats, scals, labels,
                                jnp.arange(b), jax.random.PRNGKey(1),
                                jnp.asarray(False))
        return float(stats["loss"]), float(stats["acc"]), new_state

    loss1, acc1, st1 = run(None)
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    loss8, acc8, st8 = run(mesh)
    assert abs(loss1 - loss8) < 1e-5
    assert abs(acc1 - acc8) < 1e-6
    # Parameters after one step agree across layouts, except for a tiny
    # sign-fragile set: Adam's first-step update is +/-lr regardless of |g|,
    # so a near-zero gradient whose sign depends on f32 reduction order moves
    # a full lr in opposite directions. Bound that set instead of hiding it
    # behind a loose global tolerance.
    p1 = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(st1.params)])
    p8 = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(st8.params)])
    mismatched = np.abs(p1 - p8) > 1e-4
    assert mismatched.mean() < 1e-3, mismatched.mean()
    assert np.max(np.abs(p1 - p8)) < 3 * cfg.base_lr


def test_batch_actually_sharded():
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    x = jnp.zeros((16, 4))
    y = jax.device_put(x, mesh_lib.data_sharding(mesh))
    assert len(y.sharding.device_set) == 8
