"""BASELINE config 4 at NAMED scale: order-4 self-energy renormalized series.

Order-4 sigma (innerLoopNum=4, NoHartree) -> taylorAD([2,2]) counterterm
towers (9 order tuples, all coefficient graphs through ONE shared IR) ->
fused on-device MC evaluation (sampling + leaf kernels + graph eval under
one jit), the same measurement protocol as bench.py.  Reference anchor for
the workload: /root/reference/src/utility.jl:48-93 (taylorAD) driving the
MC pipeline of /root/reference/example/benchmark.jl:39-87.

Prints one JSON line naming the device; runs on an NVIDIA GPU only.

Usage: python benchmarks/bench_config4.py [batch] [iters]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.diagram_id import (BareGreenId,
                                                         BareInteractionId)
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                      SigmaDiag, sigma)
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.utility import taylorAD
    from feynmandiagram.backends.compile import compile_evaluator
    from feynmandiagram.utils.device import (enable_compile_cache,
                                             gpu_name_and_power_limit,
                                             require_gpu_or_exit)

    devices = require_gpu_or_exit("bench_config4")
    enable_compile_cache()
    dtype = jnp.float32

    t0 = time.time()
    para = DiagPara(type=SigmaDiag, innerLoopNum=4, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    roots = [row["diagram"] for row in sigma(para, extK, False)]
    optimize_inplace(roots, level=1)
    dict_g = taylorAD(roots, [2, 2],
                      [lambda p: isinstance(p, BareGreenId),
                       lambda p: isinstance(p, BareInteractionId)])
    all_roots = [g for o in sorted(dict_g) for g in dict_g[o]]
    optimize_inplace(all_roots, level=1)
    t_host = time.time() - t0

    compiled = compile_evaluator(all_roots, max_loop_num=para.totalLoopNum,
                                 beta=0.5, kF=1.919, lam=1.0, dtype=dtype)
    low = compiled.lowered
    # a fixed batch, not yet tuned on the GPU (ROADMAP A5)
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    num_tau = para.totalTauNum

    from _mc_bench import mc_samples_per_s

    sps = mc_samples_per_s(compiled.fn, n_loop=para.totalLoopNum,
                           num_tau=num_tau, batch=batch,
                           n_roots=len(low.root_slots), dtype=dtype,
                           iters=iters, beta=0.5)
    print(json.dumps({
        "metric": "mc_samples_per_s_config4_sigma_ct22",
        "value": sps,
        "unit": "samples/s/chip",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": gpu_name_and_power_limit(),
        "extra": {
            "host_gen_ad_s": t_host,
            "edges_per_s": low.num_edges * sps,
            "batch": batch, "iters": iters,
            "num_roots": len(low.root_slots),
            "num_slots": low.num_slots, "num_edges": low.num_edges,
            "num_levels": low.num_levels,
        },
    }))


if __name__ == "__main__":
    main()
