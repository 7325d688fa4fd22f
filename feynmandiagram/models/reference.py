"""Plain numpy float64 leaf reference, independent of ``ops.leaf_eval``.

The device leaf phase (``ops.leaf_eval.make_leaf_evaluator``) is checked
against this module: it recomputes every leaf value of a graph set from the
sampled momenta and times with nothing but numpy, walking the graphs' leaves
directly instead of the lowered leaf tables.  It shares no code with the
device path, so an error in either shows as a disagreement.

Physics: free-fermion G(tau, eps, beta) with eps = k^2 - kF^2 and Yukawa
V(q) = 8 pi / (q^2 + lam), the conventions of the reference MC examples
(example/benchmark.jl:93-127).  Only derivative-order-0 leaves are covered.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

TAU_CUTOFF = 1e-10


def np_green(tau, eps, beta):
    """Fermionic kernel G(tau, eps, beta) in the stable four-branch form."""
    tau, eps = np.asarray(tau), np.asarray(eps)
    tau = np.where(np.abs(tau) < TAU_CUTOFF, -TAU_CUTOFF, tau)
    pos = tau > 0
    wpos = eps > 0
    # stable four-branch form (example/benchmark.jl:113-127)
    out = np.where(pos & wpos, np.exp(-eps * tau) / (1 + np.exp(-eps * beta)), 0.0)
    out = np.where(pos & ~wpos, np.exp(eps * (beta - tau)) / (1 + np.exp(eps * beta)), out)
    out = np.where(~pos & wpos, -np.exp(-eps * (tau + beta)) / (1 + np.exp(-eps * beta)), out)
    out = np.where(~pos & ~wpos, -np.exp(-eps * tau) / (1 + np.exp(eps * beta)), out)
    return out


def np_leaf_values(roots: Sequence, leafmap: Dict[int, int], varK, varT, *,
                   beta: float, kF: float, lam: float) -> np.ndarray:
    """Leaf values ``[len(leafmap), batch]`` in float64.

    - ``varK``: [dim, loops, batch] loop momenta
    - ``varT``: [num_tau, batch] imaginary times (1-based tau ids index rows)
    """
    from ..frontends.diagram_id import BareGreenId, BareInteractionId

    varK = np.asarray(varK, np.float64)
    varT = np.asarray(varT, np.float64)
    vals = np.ones((len(leafmap), varK.shape[-1]))
    seen = set()
    for g in roots:
        for leaf in g.leaves():
            if leaf.id in seen or leaf.operator.kind == "unitary":
                continue
            seen.add(leaf.id)
            idx = leafmap[leaf.id]
            pid = leaf.properties
            k = np.asarray(pid.extK, np.float64)
            kq = np.einsum("l,dlb->db", k, varK[:, :len(k), :])
            q2 = np.sum(kq * kq, axis=0)
            if any(o != 0 for o in leaf.orders):
                raise ValueError("np_leaf_values covers order-0 leaves only")
            if isinstance(pid, BareGreenId):
                tau = varT[pid.extT[1] - 1] - varT[pid.extT[0] - 1]
                vals[idx] = np_green(tau, q2 - kF ** 2, beta)
            elif isinstance(pid, BareInteractionId):
                vals[idx] = 8 * math.pi / (q2 + lam)
            else:
                raise ValueError(f"unsupported leaf id {type(pid)}")
    return vals
