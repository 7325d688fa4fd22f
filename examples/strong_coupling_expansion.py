"""Strong-coupling (hopping) expansion worked example on the ED Atom oracle.

The reference carries a complete SCE application built on an
exact-diagonalization Atom package
(/root/reference/example/strong_coupling_expansion/; the builder itself is
dormant, frontends.jl:97-98).  This example revives the physics on the
models.atom_ed oracle: around the atomic limit, the lattice Green's
function expands in the hopping t with ATOMIC correlation functions as
building blocks.  For the Hubbard dimer, the leading off-diagonal term is
one hopping line joining two exact atomic propagators:

    G_01(iw_n) = t * g_atom(iw_n)^2 + O(t^3)

(odd in t, so the next correction is t^3).  The script checks this against
the full dimer ED at several t and prints the convergence table — the
independent anchor a future SCE graph builder must reproduce, with the
connected 4-point `g2_connected` supplying the higher-order vertices.

Usage: python examples/strong_coupling_expansion.py [U] [mu] [beta]
"""
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from feynmandiagram.utils.device import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)

    from feynmandiagram.models.atom_ed import (hubbard_atom_model,
                                                   hubbard_dimer_model)

    u = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    mu = float(sys.argv[2]) if len(sys.argv) > 2 else 0.3
    beta = float(sys.argv[3]) if len(sys.argv) > 3 else 1.2

    atom = hubbard_atom_model(u, mu, beta)
    g_at = atom.g_matsubara(3)
    print(f"# Hubbard dimer vs 1st-order hopping expansion "
          f"(U={u}, mu={mu}, beta={beta})")
    print(f"{'t':>6} {'n':>2} {'|G01_ED - t*g^2|':>18} {'.. / t^3':>10}")
    for t in (0.02, 0.05, 0.1, 0.2):
        dimer = hubbard_dimer_model(t, u, mu, beta)
        g01 = dimer.g_matsubara(3, 0, 1)   # site0-up <- site1-up
        for n in range(3):
            err = abs(g01[n] - t * g_at[n] ** 2)
            print(f"{t:>6} {n:>2} {err:>18.3e} {err / t**3:>10.4f}")

    # the atomic connected vertex (the O(t^2) SCE ingredient)
    gc = atom.g2_connected(0.8 * beta, 0.35 * beta, 0.6 * beta, 0.1 * beta,
                           0, 1, 1, 0)
    print(f"# atomic connected 4-point at sample times: {gc:.6f} "
          "(vanishes at U=0; feeds the O(t^2) SCE diagrams)")


if __name__ == "__main__":
    main()
