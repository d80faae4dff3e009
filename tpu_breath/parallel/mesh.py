"""Device mesh + sharding layout.

The reference is single-process/single-device with no distributed machinery
(SURVEY.md §2.4); here data parallelism is a first-class property of the
program: one 1-D ("data",) mesh, batches sharded along it, parameters and
optimizer state replicated, and gradient reduction left to XLA-inserted
all-reduces (NCCL between GPUs). The same jitted train step runs unchanged
on 1 GPU, an 8-device CPU simulation, or several GPUs on several hosts —
only the mesh differs. The mesh is 1-D: the cards of one host are joined
all to all, so no axis needs a topology-aware shape.

Multi-host entry goes through jax.distributed.initialize() (initialize()
below); there is no NCCL/MPI code to hand-write.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding for activations/batches."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """Constrain the leading (batch) axis of every array in the pytree to the
    data axis; under jit XLA partitions accordingly."""
    spec = data_sharding(mesh)
    return jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, spec),
                        batch)


def initialize_distributed() -> None:
    """Multi-host entry: no-op on a single host or when the launcher already
    called jax.distributed.initialize (e.g. tests/mp_worker.py)."""
    import os
    from jax._src import distributed as _dist
    if _dist.global_state.client is not None:
        return
    if "JAX_COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize()
