"""Vectorized leaf evaluation: SoA leaf tables -> batched leaf values.

Replaces the reference's per-sample scalar loop (example/benchmark.jl:60-87)
with a few fused tensor ops per (leaf-type, derivative-order) group:

1. ``loops = einsum(varK, basis)`` — the LoopPool.update matmul, batched
2. per-group gather of (tau_in, tau_out, loop_idx) and one vectorized
   physics kernel call, scattered into the [num_leaves, batch] buffer

All grouping is static (decided at trace time from the tables).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.free_fermion import green_derive_tower
from ..models.yukawa import interaction_derive
from .evaluator import resolve_layout


@dataclass
class LeafTables:
    """Static per-leaf metadata (SoA), slot-aligned with the lowered graph."""
    leaf_type: np.ndarray     # [L] int: 1=BareGreenId, 2=BareInteractionId
    g_order: np.ndarray       # [L] int: G-counterterm derivative order
    v_order: np.ndarray       # [L] int: V-counterterm derivative order
    tau_in: np.ndarray        # [L] int, 1-based tau index
    tau_out: np.ndarray       # [L] int, 1-based tau index
    loop_idx: np.ndarray      # [L] int, 0-based index into the loop basis
    loop_basis: np.ndarray    # [n_basis, max_loop_num]

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_type)


def leaf_tables_from_lowered(lowered, leaf_graphs: Dict[int, "Graph"],
                             max_loop_num: int) -> LeafTables:
    """Build LeafTables for the non-constant leaf slots of a LoweredGraph.

    ``leaf_graphs`` maps leaf uid -> leaf Graph (carrying DiagramId
    properties and derivative orders).
    """
    from ..frontends.diagram_id import BareGreenId, BareInteractionId

    n_input = lowered.num_leaves - len(lowered.const_slots)
    leaf_type = np.zeros(n_input, np.int32)
    g_order = np.zeros(n_input, np.int32)
    v_order = np.zeros(n_input, np.int32)
    tau_in = np.ones(n_input, np.int32)
    tau_out = np.ones(n_input, np.int32)
    loop_idx = np.zeros(n_input, np.int32)
    loop_basis: List[np.ndarray] = []

    for uid, slot in lowered.leaf_uid_to_slot.items():
        if slot >= n_input:
            continue
        leaf = leaf_graphs[uid]
        diag_id = leaf.properties
        k = np.zeros(max_loop_num)
        extk = np.asarray(diag_id.extK, float)
        if len(extk) > max_loop_num:
            raise ValueError("extK longer than max_loop_num")
        k[:len(extk)] = extk
        for bi, b in enumerate(loop_basis):
            if np.allclose(b, k, rtol=1.49e-8):
                loop_idx[slot] = bi
                break
        else:
            loop_basis.append(k)
            loop_idx[slot] = len(loop_basis) - 1
        tau_in[slot], tau_out[slot] = diag_id.extT[0], diag_id.extT[1]
        orders = list(leaf.orders) + [0, 0]
        g_order[slot], v_order[slot] = orders[0], orders[1]
        if isinstance(diag_id, BareGreenId):
            leaf_type[slot] = 1
        elif isinstance(diag_id, BareInteractionId):
            leaf_type[slot] = 2
        else:
            raise ValueError(f"unsupported leaf id {type(diag_id)}")

    return LeafTables(leaf_type, g_order, v_order, tau_in, tau_out, loop_idx,
                      np.stack(loop_basis) if loop_basis else np.zeros((0, max_loop_num)))


def make_leaf_evaluator(tables: LeafTables, *, beta: float, kF: float, lam: float,
                        dtype=None, interaction_convention: str = "lambda_power",
                        layout: str = "flat"):
    """Build ``f(varK, varT) -> leaf_values[num_leaves, batch]``.

    - ``varK``: [dim, max_loop_num, batch] sampled loop momenta
    - ``varT``: [num_tau, batch] sampled imaginary times
    - ``layout``: 'tile' emits ``[num_leaves, batch//128, 128]`` natively
      — the tile-row form the tile-layout graph evaluator consumes — so no
      [num_leaves, batch] relayout is needed at the phase boundary; 'auto'
      resolves as ``ops.evaluator.resolve_layout`` does for the graph phase.
    """
    if dtype is None:
        from .dtypes import default_device_dtype
        dtype = default_device_dtype()
    basis = jnp.asarray(tables.loop_basis, dtype)          # [n_basis, maxloop]
    groups: List[Tuple[int, int, np.ndarray]] = []
    for t in (1, 2):
        mask = tables.leaf_type == t
        orders = tables.g_order if t == 1 else tables.v_order
        for o in sorted(set(orders[mask].tolist())):
            idx = np.where(mask & (orders == o))[0]
            groups.append((t, int(o), idx))

    tau_in = jnp.asarray(tables.tau_in - 1)
    tau_out = jnp.asarray(tables.tau_out - 1)
    loop_idx = jnp.asarray(tables.loop_idx)

    def evaluate(varK: jnp.ndarray, varT: jnp.ndarray) -> jnp.ndarray:
        varK = jnp.asarray(varK, dtype)
        varT = jnp.asarray(varT, dtype)
        batch = varK.shape[-1]
        tile = resolve_layout(layout) == "tile"
        # LoopPool.update as one batched matmul (pool.jl:69-76).  HIGHEST:
        # a float32 product may otherwise run in TF32 (~1e-3 relative
        # error in the momenta) on GPUs with tensor cores.
        with jax.named_scope("loops"):
            loops = jnp.einsum("nl,dlb->dnb", basis, varK,  # [dim, n_basis, batch]
                               precision=jax.lax.Precision.HIGHEST)
            q2 = jnp.sum(loops * loops, axis=0)             # [n_basis, batch]
        if tile:
            nsub = batch // 128
            q2 = q2.reshape(len(q2), nsub, 128)
            varT = varT.reshape(len(varT), nsub, 128)
            out = jnp.ones((tables.num_leaves, nsub, 128), dtype)
        else:
            out = jnp.ones((tables.num_leaves, batch), dtype)
        for t, order, idx in groups:
            if len(idx) == 0:
                continue
            gidx = jnp.asarray(idx)
            with jax.named_scope(f"leaf{'G' if t == 1 else 'V'}{order}"):
                q2_g = q2[loop_idx[gidx]]                  # [n_g, batch...]
                if t == 1:
                    tau = varT[tau_out[gidx]] - varT[tau_in[gidx]]
                    eps = q2_g - kF ** 2
                    vals = green_derive_tower(tau, eps, beta, order)
                else:
                    vals = interaction_derive(q2_g, lam, order,
                                              convention=interaction_convention)
                    vals = jnp.broadcast_to(vals, q2_g.shape)
                out = out.at[gidx].set(vals.astype(dtype))
        return out

    return evaluate
