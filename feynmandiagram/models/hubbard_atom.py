"""Hubbard-atom end-to-end physics oracle.

The Hubbard atom H = U n_up n_down - mu (n_up + n_down) has a closed-form
self-energy, so the FULL pipeline — parquet sigma diagrams -> lowering ->
batched graph evaluation -> Matsubara phase -> Monte-Carlo tau integration —
can be checked against an analytic answer order by order in U.

Reference: docs/src/manual/hubbard_atom.md (closed form and the power series
at i*omega_0, mu=0) and the legacy MC test test/hubbard.jl:1-114 (leaf rules:
G leaf = kernelFermiT(tau, -mu, beta) with tau==0 -> 0^-, V leaf = U; root
phase exp(i*pi*(2n+1)/beta * (t_out - t_in))).

There is no momentum here: the atom is a single site, so the BareGreenId
momenta produced by the parquet builder are simply ignored by the leaf rules
(hubbard.jl:42-52 does the same).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .free_fermion import green_kernel


def exact_sigma(iw, U: float, beta: float, mu: float = 0.0):
    """Closed-form Sigma(i*omega) of the Hubbard atom
    (hubbard_atom.md:55-58)."""
    iw = complex(0.0, iw) if not isinstance(iw, complex) else iw
    ebm = math.exp(beta * mu)
    ebu = math.exp(beta * U)
    num = U * ebm * (mu + iw) * (ebm + ebu)
    den = (ebu * (-mu + U - iw) + ebm * ebu * (-2 * mu + U - 2 * iw)
           - ebm * ebm * (mu + iw))
    return num / den


def sigma_power_series(beta: float, max_order: int = 5) -> List[complex]:
    """Coefficients of Sigma(i*omega_0) = sum_o c_o U^o at mu=0
    (hubbard_atom.md:60-62); c_o includes everything except the U^o power."""
    pi = math.pi
    coeffs = [
        -0.5,
        (pi + 2j) * beta / (8 * pi),
        -(pi ** 2 - 4) * beta ** 2 / (32 * pi ** 2),
        -(24j - 12 * pi + 6j * pi ** 2 + pi ** 3) * beta ** 3 / (384 * pi ** 3),
        (-48 - 48j * pi - 24 * pi ** 2 + 12j * pi ** 3 + 5 * pi ** 4)
        * beta ** 4 / (1536 * pi ** 4),
    ]
    if max_order > len(coeffs):
        raise ValueError("series known to order 5 only")
    return coeffs[:max_order]


@dataclass
class HubbardSigma:
    """One diagram order of the Hubbard-atom self-energy, compiled."""
    order: int
    num_tau: int           # totalTauNum: varT rows (varT[0] pinned to 0)
    fn: callable           # (varT[num_tau, batch], U) -> [2, batch] (re, im)


def build_sigma_evaluator(order: int, beta: float, *, mu: float = 0.0,
                          matsubara_n: int = 0,
                          dtype=None) -> HubbardSigma:
    """Compile the order-``order`` sigma diagrams into one jitted function
    (varT, U) -> per-sample complex Sigma integrand (phase included)."""
    from ..frontends import Instant, UpDown
    from ..frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
    from ..computational_graph import optimize_inplace
    from ..backends.compile import leafmap_of, leaf_graphs_of
    from ..ops import lower
    from ..ops.evaluator import make_evaluator
    from ..ops.leaf_eval import leaf_tables_from_lowered

    if dtype is None:
        from ..ops.dtypes import default_device_dtype
        dtype = default_device_dtype()

    para = DiagPara(type=SigmaDiag, innerLoopNum=order, hasTau=True,
                    interaction=(Interaction(UpDown, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    rows = sigma(para, extK, False)
    roots = [r["diagram"] for r in rows]
    ext_ts = [tuple(r["extT"]) for r in rows]
    optimize_inplace(roots, level=1)

    leafmap = leafmap_of(roots)
    lowered = lower(roots, leafmap, sum_mode="bucketed")
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                      para.totalLoopNum)
    if (tables.g_order != 0).any() or (tables.v_order != 0).any():
        raise AssertionError("Hubbard oracle has no counterterm leaves")

    graph_fn = make_evaluator(lowered, dtype=dtype, jit=False)
    g_idx = np.where(tables.leaf_type == 1)[0]
    v_idx = np.where(tables.leaf_type == 2)[0]
    g_tin = jnp.asarray(tables.tau_in[g_idx] - 1)
    g_tout = jnp.asarray(tables.tau_out[g_idx] - 1)
    omega = math.pi * (2 * matsubara_n + 1) / beta
    # (t_in, t_out) per root, 0-based into varT (hubbard.jl:37-40)
    root_tin = jnp.asarray([t[0] - 1 for t in ext_ts])
    root_tout = jnp.asarray([t[1] - 1 for t in ext_ts])
    num_leaves = lowered.num_leaves - len(lowered.const_slots)

    def fn(varT, U):
        # complex is kept out of the graph (the evaluator is real-only):
        # the Matsubara phase is applied as real cos/sin channels
        varT = jnp.asarray(varT, dtype)
        batch = varT.shape[-1]
        leaf = jnp.ones((num_leaves, batch), dtype)
        tau = varT[g_tout] - varT[g_tin]
        leaf = leaf.at[jnp.asarray(g_idx)].set(green_kernel(tau, -mu, beta))
        if len(v_idx):
            leaf = leaf.at[jnp.asarray(v_idx)].set(
                jnp.full((len(v_idx), batch), U, dtype))
        w = graph_fn(leaf)                               # [R, batch] real
        dt = varT[root_tout] - varT[root_tin]            # [R, batch]
        re = jnp.sum(w * jnp.cos(omega * dt), axis=0)
        im = jnp.sum(w * jnp.sin(omega * dt), axis=0)
        return jnp.stack([re, im])                       # [2, batch]

    return HubbardSigma(order, para.totalTauNum, jax.jit(fn, static_argnums=()))


def sigma_mc(order: int, U: float, beta: float, *, mu: float = 0.0,
             matsubara_n: int = 0, batch: int = 8192, chunks: int = 32,
             seed: int = 0, dtype=None) -> Tuple[complex, complex]:
    """Uniform-tau Monte-Carlo estimate of Sigma^(order)(i*omega_n).

    varT[0] is pinned to 0 (hubbard.jl:76-78); the remaining num_tau-1
    variables are uniform on [0, beta), so the integral is
    beta^(num_tau-1) * mean(integrand).  Returns (mean, stderr) with stderr
    reported per real/imag component.
    """
    if dtype is None:
        from ..ops.dtypes import default_device_dtype
        dtype = default_device_dtype()
    hs = build_sigma_evaluator(order, beta, mu=mu, matsubara_n=matsubara_n,
                               dtype=dtype)
    nfree = hs.num_tau - 1
    vol = beta ** nfree
    key = jax.random.PRNGKey(seed)
    means = []
    for c in range(chunks):
        k = jax.random.fold_in(key, c)
        t_free = jax.random.uniform(k, (nfree, batch), dtype) * beta
        varT = jnp.concatenate([jnp.zeros((1, batch), dtype), t_free], axis=0)
        re, im = np.asarray(jnp.mean(hs.fn(varT, U), axis=1))
        means.append(complex(re, im) * vol)
    means = np.asarray(means)
    mean = means.mean()
    if chunks > 1:
        err = (means.real.std(ddof=1) + 1j * means.imag.std(ddof=1)) / math.sqrt(chunks)
    else:
        err = 0.0
    return mean, err
