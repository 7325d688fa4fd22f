"""CLI: generate the bundled diagram tables.

    python -m feynmandiagram.frontends.gv.generator [out_dir] \
        [--max-total-order N] [--vertex4-max N] [--kinds a,b,c]

Writes .diag tables (the contract consumed by frontends.gv.readfile) into
``out_dir`` (default: the package tables/ directory).
"""
import argparse
import os
import sys
import time

from .tables import (generate_free_energy, generate_green, generate_polar,
                     generate_sigma, generate_vertex4, write_table)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?",
                    default=os.path.join(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))), "tables"))
    ap.add_argument("--max-total-order", type=int, default=5,
                    help="max of order + ver_ct + g_ct for sigma/polar/green/lnZ")
    ap.add_argument("--vertex4-max", type=int, default=3)
    ap.add_argument("--vertex4i", default="3",
                    help="comma-separated Vertex4I orders (or empty)")
    ap.add_argument("--kinds", default="sigma,charge,spin,green,free_energy,vertex4")
    args = ap.parse_args(argv)

    kinds = set(args.kinds.split(","))
    total = args.max_total_order
    t0 = time.time()

    def emit(sub, name, text):
        p = write_table(os.path.join(args.out_dir, sub, name), text)
        print(f"[{time.time() - t0:7.1f}s] {'wrote' if p else 'empty'} {sub}/{name}",
              flush=True)

    for o in range(1, total + 1):
        for v in range(0, total):
            for g in range(0, total):
                if o + v + g > total:
                    continue
                if "sigma" in kinds:
                    emit("groups_sigma", f"Sigma{o}_{v}_{g}.diag",
                         generate_sigma(o, v, g))
                if "charge" in kinds:
                    emit("groups_charge", f"Polar{o}_{v}_{g}.diag",
                         generate_polar(o, v, g, is_spin_polar=False))
                if "spin" in kinds:
                    emit("groups_spin", f"Polar{o}_{v}_{g}.diag",
                         generate_polar(o, v, g, is_spin_polar=True))
                if "green" in kinds and o + 1 + v + g <= total:
                    emit("groups_green", f"Green{o}_{v}_{g}.diag",
                         generate_green(o, v, g))
                if "free_energy" in kinds:
                    emit("groups_free_energy", f"FreeEnergy{o}_{v}_{g}.diag",
                         generate_free_energy(o, v, g))

    if "vertex4" in kinds:
        for o in range(1, args.vertex4_max + 1):
            emit("groups_vertex4", f"Vertex4{o}_0_0.diag", generate_vertex4(o))
        for o in (int(x) for x in args.vertex4i.split(",") if x):
            emit("groups_vertex4", f"Vertex4I{o}_0_0.diag",
                 generate_vertex4(o, fully_irreducible=True))
    print(f"done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
