"""Taylor-mode AD demo (counterpart of reference example/taylor_expansion.jl).

Builds order-2 sigma via Parquet, expands in G/V counterterm orders, and
reports the op-count sharing statistics of the coefficient graphs.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from feynmandiagram.computational_graph import count_operation, optimize_inplace
from feynmandiagram.frontends import (BareGreenId, BareInteractionId,
                                          ChargeCharge, Instant, NoHartree)
from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  SigmaDiag, sigma)
from feynmandiagram.utility import taylorAD


def main():
    para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    df = sigma(para, extK, False)
    roots = [row["diagram"] for row in df]
    optimize_inplace(roots)

    dict_g = taylorAD(roots, [2, 2],
                      [lambda p: isinstance(p, BareGreenId),
                       lambda p: isinstance(p, BareInteractionId)])
    print("derivative orders:", sorted(dict_g))
    all_graphs = [g for graphs in dict_g.values() for g in graphs]
    adds, muls = count_operation(all_graphs)
    print(f"shared op count over all orders: {adds} adds, {muls} muls")
    for order in sorted(dict_g):
        a, m = count_operation(dict_g[order])
        print(f"  order {order}: {a} adds, {m} muls")


if __name__ == "__main__":
    main()
