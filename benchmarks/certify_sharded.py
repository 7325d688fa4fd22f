"""Certify the graph-sharded evaluator at BASELINE-config-5 scale.

Order-N vertex-4 through the FULL production path — parquet build ->
optimize(level=1) -> fused lowering (reuse_slots=False, single-assignment
ownership) -> memory-partitioned sharded evaluation on an n-device mesh —
asserting the sharded result equals the single-chip evaluator and printing
the planner's memory/halo footprint as one JSON line.

The mesh is a virtual n-device CPU mesh (real collectives, no GPU): the
certification covers planning, memory partitioning, halo exchange, and
bit-level equality; its wall-clock is not a device measurement.

Usage: [FD_CERT_ORDER=6] [FD_CERT_NDEV=8] [FD_CERT_BATCH=4]
       python benchmarks/certify_sharded.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count="
        + os.environ.get("FD_CERT_NDEV", "8")).strip()

import numpy as np


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from feynmandiagram.utils.device import enable_compile_cache

    enable_compile_cache()

    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                      Ver4Diag, vertex4)
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.backends.compile import leafmap_of
    from feynmandiagram.ops import lower, make_evaluator
    from feynmandiagram.parallel import make_sample_mesh
    from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator

    order = int(os.environ.get("FD_CERT_ORDER", 5))
    n_dev = int(os.environ.get("FD_CERT_NDEV", 8))
    batch = int(os.environ.get("FD_CERT_BATCH", 4))

    t0 = time.time()
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [r["diagram"] for r in vertex4(para)]
    t_gen = time.time() - t0
    t0 = time.time()
    optimize_inplace(roots, level=1)
    t_opt = time.time() - t0
    lm = leafmap_of(roots)
    t0 = time.time()
    from feynmandiagram.parallel.graph_shard import lower_sharded_best
    lowered, sched = lower_sharded_best(roots, lm, n_dev)
    live = lower(roots, lm, sum_mode="fused", cse=True, reuse_slots=True)
    t_low = time.time() - t0

    nl = lowered.num_leaves - len(lowered.const_slots)
    vals = np.random.default_rng(3).uniform(0.5, 1.5, (nl, batch))
    t0 = time.time()
    single = np.asarray(make_evaluator(lowered)(vals))
    t_single = time.time() - t0

    mesh = make_sample_mesh(n_dev, axis_name="graph")
    t0 = time.time()
    sharded = make_graph_sharded_evaluator(lowered, mesh)
    t_plan = time.time() - t0
    t0 = time.time()
    multi = np.asarray(sharded(vals))
    t_shard = time.time() - t0
    np.testing.assert_allclose(multi, single, rtol=1e-10, atol=1e-12)

    st = sharded.stats
    print(json.dumps({
        "order": order, "n_dev": n_dev, "batch": batch,
        "schedule": sched,
        "full_slots": int(st.full_slots),
        "live_slots_single_chip": int(live.num_slots),
        "local_slots_per_device": int(st.local_slots),
        "local_vs_live_over_n": round(st.local_slots / (live.num_slots / n_dev), 3),
        "num_edges": int(lowered.num_edges),
        "num_levels": int(lowered.num_levels),
        "halo_rows_total": int(sum(st.halo_rows_per_level)),
        "halo_pad_overhead": round(st.halo_pad_overhead, 3),
        "early_share": round(st.early_share, 3),
        "interleaved": bool(st.interleaved),
        "halo_MB_per_sample_f32": round(st.halo_bytes_per_sample() / 2**20, 3),
        "equal_to_single_chip": True,
        "t_generate_s": round(t_gen, 1), "t_optimize_s": round(t_opt, 1),
        "t_lower_s": round(t_low, 1), "t_plan_s": round(t_plan, 1),
        "t_eval_single_s": round(t_single, 1),
        "t_eval_sharded_s": round(t_shard, 1),
    }))


if __name__ == "__main__":
    main()
