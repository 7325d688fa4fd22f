"""End-to-end MC estimate of the two-loop self-energy (BASELINE config 1).

Parquet generation -> optimize -> fused device evaluation of 1e4+ Monte-Carlo
samples -> crude importance-free estimator means.  Counterpart of the
reference example/benchmark.jl driver.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import jax
import numpy as np

from feynmandiagram.backends import compile_evaluator
from feynmandiagram.computational_graph import optimize_inplace
from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  SigmaDiag, sigma)
from feynmandiagram.parallel import make_sample_mesh, make_mc_step
from feynmandiagram.utils.device import enable_compile_cache

KF, BETA, LAM = 1.919, 0.5, 1.0


def main(batch=10000):
    enable_compile_cache()
    para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    df = sigma(para, extK, False)
    roots = [row["diagram"] for row in df]
    optimize_inplace(roots)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                 beta=BETA, kF=KF, lam=LAM, sum_mode="bucketed")

    rng = np.random.default_rng(0)
    varK = rng.standard_normal((3, para.totalLoopNum, batch)) * KF
    varK[:, 0, :] = np.array([[KF], [0.0], [0.0]])
    varT = rng.random((para.totalTauNum, batch)) * BETA

    t0 = time.time()
    weights = np.asarray(compiled(varK, varT))
    dt = time.time() - t0
    print(f"evaluated {batch} samples x {weights.shape[0]} sigma groups "
          f"in {dt * 1e3:.1f} ms ({batch / dt:,.0f} samples/s)")
    for row, mean in zip(df, weights.mean(axis=1)):
        print(f"  extT={row['extT']}: mean weight {mean:+.6e}")

    # multi-chip estimation step over the available mesh
    mesh = make_sample_mesh()
    step = jax.jit(make_mc_step(compiled, mesh, beta=BETA), static_argnums=1)
    means = np.asarray(step(jax.random.PRNGKey(0), 1024))
    print(f"mesh({mesh.devices.size} devices) MC step means: {means[:3]} ...")


if __name__ == "__main__":
    main()
