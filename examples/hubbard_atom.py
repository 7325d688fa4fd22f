"""Hubbard-atom self-energy: exact vs diagrammatic MC through the device pipeline.

The Hubbard atom (single site, H = U n_up n_down - mu N) has a closed-form
self-energy, making it an end-to-end physics oracle for the whole framework:
parquet sigma diagrams -> lowering -> batched graph evaluation -> Matsubara
phase -> Monte-Carlo tau integration.

Run:  python examples/hubbard_atom.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import math

from feynmandiagram.utils.device import enable_compile_cache
from feynmandiagram.models.hubbard_atom import (exact_sigma,
                                                    sigma_power_series,
                                                    sigma_mc)

BETA, U = 2.3, 1.0


def main():
    enable_compile_cache()
    coeffs = sigma_power_series(BETA)
    print(f"Hubbard atom, beta={BETA}, U={U}, mu=0, at i*omega_0")
    print(f"closed form  Sigma(i w0) = {exact_sigma(math.pi / BETA, U, BETA):.6f}")
    print()
    print(f"{'order':>5} {'MC estimate':>28} {'stderr':>22} {'analytic':>24}")
    for order in (1, 2, 3):
        mean, err = sigma_mc(order, U, BETA, batch=8192, chunks=16, seed=order)
        expect = coeffs[order - 1] * U ** order
        print(f"{order:>5} {mean:>28.6f} {err:>22.6f} {expect:>24.6f}")


if __name__ == "__main__":
    main()
