"""Sample-axis data parallelism over a jax.sharding.Mesh.

Design (not a port — the reference is single-process):
- inputs varK [dim, loops, batch] / varT [taus, batch] are sharded on the
  trailing batch axis; the lowered-graph tables are replicated
- the fused evaluator runs unchanged under jit: XLA partitions every
  per-sample op along the batch axis with zero communication
- the MC estimation step reduces per-device partial means with one pmean
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_sample_mesh(n_devices: Optional[int] = None, *, axis_name: str = BATCH_AXIS,
                     devices=None) -> Mesh:
    """A 1-D device mesh over the MC sample axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_compiled(compiled, mesh: Mesh, *, axis_name: str = BATCH_AXIS):
    """Wrap a CompiledEvaluator with batch-axis shardings.

    Returns ``f(varK, varT) -> roots[R, batch]`` jitted with input/output
    shardings; the batch size must divide the mesh size.
    """
    batch_k = NamedSharding(mesh, P(None, None, axis_name))
    batch_t = NamedSharding(mesh, P(None, axis_name))
    out_sharding = NamedSharding(mesh, P(None, axis_name))

    def fn(varK, varT):
        leaf_values = compiled.leaf_fn(varK, varT)
        return compiled.graph_fn(leaf_values)

    return jax.jit(fn, in_shardings=(batch_k, batch_t),
                   out_shardings=out_sharding)


def make_mc_step(compiled, mesh: Mesh, *, beta: float, axis_name: str = BATCH_AXIS,
                 dtype=None):
    """One full Monte-Carlo estimation step, SPMD over the mesh.

    Each device draws its own sample shard from a per-device PRNG fold
    (``fold_in(key, device_index)``; samples drawn in ``dtype``, default
    JAX's default float), evaluates all root weights, and the global
    estimator mean reduces with a single ``pmean``.  Returns
    ``step(key, batch_per_device) -> means[R]``; jit once, run many.
    """
    n_dev = mesh.devices.size
    dim = 3
    max_loop = compiled.max_loop_num
    num_tau = int(max(compiled.tables.tau_in.max(), compiled.tables.tau_out.max()))

    def per_device(key):
        idx = jax.lax.axis_index(axis_name)
        key = jax.random.fold_in(key[0], idx)
        k1, k2 = jax.random.split(key)
        return k1, k2

    def step(key, batch_per_device: int):
        def device_fn(key):
            k1, k2 = per_device(key)
            varK = jax.random.normal(k1, (dim, max_loop, batch_per_device),
                                     dtype)
            varT = jax.random.uniform(k2, (num_tau, batch_per_device),
                                      dtype) * beta
            leaf_values = compiled.leaf_fn(varK, varT)
            roots = compiled.graph_fn(leaf_values)  # [R, batch_per_device]
            partial = jnp.mean(roots, axis=1)
            return jax.lax.pmean(partial, axis_name)

        sharded = jax.shard_map(device_fn, mesh=mesh, in_specs=(P(axis_name),),
                            out_specs=P())
        keys = jnp.broadcast_to(key, (n_dev,) + key.shape)
        return sharded(keys)

    return step
