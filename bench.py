"""Benchmark: MC samples/s on the fused order-4 vertex-4 evaluation.

BASELINE config: order-4 Gamma4 parquet graph -> optimize(level=1) -> lower
-> fused leaf+graph evaluation of Monte-Carlo sample batches on one chip.

Prints ONE JSON line {"metric", "value", "unit", "device", "card", "extra"}
naming the device it ran on.  Runs on an NVIDIA GPU only: on any other
platform it exits non-zero and prints no result.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from feynmandiagram.utils.device import (enable_compile_cache,
                                             gpu_name_and_power_limit,
                                             require_gpu_or_exit)

    devices = require_gpu_or_exit("bench")
    enable_compile_cache()

    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                      Ver4Diag, vertex4)
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.backends.compile import compile_evaluator

    dtype = jnp.float32

    order = int(os.environ.get("FD_BENCH_ORDER", 4))
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    df = vertex4(para)
    roots = [row["diagram"] for row in df]
    optimize_inplace(roots, level=1)
    sum_mode = os.environ.get("FD_BENCH_SUM_MODE", "fused")
    merge_threshold = int(os.environ.get("FD_BENCH_MERGE", 0))
    layout = os.environ.get("FD_BENCH_LAYOUT", "auto")
    chunk = os.environ.get("FD_BENCH_CHUNK")
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                 beta=0.5, kF=1.919, lam=1.0, dtype=dtype,
                                 sum_mode=sum_mode, merge_threshold=merge_threshold,
                                 layout=layout,
                                 chunk_rows=int(chunk) if chunk else None)

    # a fixed batch, not yet tuned on the GPU (ROADMAP A5)
    batch = int(os.environ.get("FD_BENCH_BATCH", 2048))
    rng = np.random.default_rng(0)
    varK = jax.device_put(rng.standard_normal((3, para.totalLoopNum, batch)).astype(np.float32))
    varT = jax.device_put((rng.random((para.totalLoopNum, batch)) * 0.5).astype(np.float32))

    reps = int(os.environ.get("FD_BENCH_REPS", 3))
    # default mode is the production MC shape: sampling + leaf physics +
    # graph eval all on device under one jit (fori_loop), no host dispatch
    # per pass
    fused = os.environ.get("FD_BENCH_FUSED", "1") == "1"
    iters = int(os.environ.get("FD_BENCH_ITERS", 200 if fused else 50))
    if fused:
        # the production MC shape (shared protocol: benchmarks/_mc_bench.py)
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "benchmarks"))
        from _mc_bench import mc_samples_per_s

        sps = mc_samples_per_s(compiled.fn, n_loop=para.totalLoopNum,
                               num_tau=para.totalTauNum, batch=batch,
                               n_roots=len(compiled.lowered.root_slots),
                               dtype=dtype, iters=iters, reps=reps, beta=0.5)
        dt = batch * iters / sps
    else:
        out = compiled(varK, varT)
        jax.block_until_ready(out)  # compile + warmup
        # median of `reps` timing repetitions: steady-state throughput
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = compiled(varK, varT)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[len(times) // 2]

    samples_per_s = batch * iters / dt
    edges_per_s = compiled.lowered.num_edges * samples_per_s
    # every edge is one gathered row operand of `batch` samples
    gathered_tb_s = edges_per_s * np.dtype(dtype).itemsize / 1e12
    result = {
        "metric": f"mc_samples_per_s_order{order}_ver4",
        "value": samples_per_s,
        "unit": "samples/s/chip",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": gpu_name_and_power_limit(),
        "extra": {
            "edges_per_s": edges_per_s,
            "gathered_row_tb_s": gathered_tb_s,
            "batch": batch,
            "iters": iters,
            "num_nodes": compiled.lowered.num_slots,
            "num_edges": compiled.lowered.num_edges,
            "sum_mode": sum_mode,
            "layout": layout,
            "fused": fused,
            "merge_threshold": merge_threshold,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
