"""BASELINE config-5 workflow: generate once, serve sharded.

Job 1 (generation, any host): build the order-N vertex-4 graph via parquet,
optimize, lower with single-assignment slots, export one .npz artifact.

Job 2 (serving, 4 or more GPUs): load the artifact — no parquet, no
symbolic graphs — and run the Monte-Carlo estimation step with the graph
memory-partitioned over the ``graph`` mesh axis and samples data-parallel
over the ``batch`` axis.  The mesh is built from the devices present,
shaped (n // 2, 2) as (graph, batch); fewer than 4 devices is an error.
Usage:

    python examples/config5_serving.py [order] [artifact.npz]
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def generate(order: int, path: str, n_graph: int) -> None:
    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                      Ver4Diag, vertex4)
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.backends.compile import (leafmap_of,
                                                     leaf_graphs_of,
                                                     save_lowered)
    from feynmandiagram.ops.leaf_eval import leaf_tables_from_lowered
    from feynmandiagram.parallel.graph_shard import lower_sharded_best

    t0 = time.time()
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(roots, level=1)
    # generate-once: lower under BOTH level schedules and keep the plan
    # with the smaller per-device footprint on the serving graph axis
    lowered, sched = lower_sharded_best(roots, leafmap_of(roots), n_graph,
                                        cse=True)
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                      para.totalLoopNum)
    save_lowered(path, lowered, tables)
    print(f"[generate] order {order}: {len(roots)} roots "
          f"(schedule={sched}) -> {path} "
          f"({os.path.getsize(path)/2**20:.1f} MB) in {time.time()-t0:.1f} s")


def serving_devices():
    """An even number (>= 4) of the devices present."""
    import jax

    from feynmandiagram.utils.device import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"config-5 serving needs at least 4 devices; found "
                         f"{len(devs)} ({devs[0].platform})")
    return devs[:len(devs) // 2 * 2]


def serve(path: str, devs, batch_per_device: int = 8, iters: int = 4) -> None:
    import jax
    from jax.sharding import Mesh
    from feynmandiagram.backends.compile import load_artifact
    from feynmandiagram.parallel import make_graph_sharded_mc_step

    lowered, tables = load_artifact(path)
    devices = np.asarray(devs).reshape(len(devs) // 2, 2)
    mesh = Mesh(devices, ("graph", "batch"))
    step = make_graph_sharded_mc_step(lowered, tables, mesh,
                                      beta=0.5, kF=1.919, lam=1.0)
    st = step.stats
    print(f"[serve] {lowered.num_slots} slots -> {st.local_slots}/device "
          f"on a {dict(zip(mesh.axis_names, mesh.devices.shape))} mesh; "
          f"halo {st.halo_bytes_per_sample()/1024:.1f} KiB/sample "
          f"(pad {st.halo_pad_overhead:.3f}, early {st.early_share:.2f})")
    t0 = time.time()
    means = np.asarray(step(jax.random.PRNGKey(0), batch_per_device, iters))
    dt = time.time() - t0
    n = batch_per_device * iters * mesh.shape["batch"]
    print(f"[serve] {n} samples in {dt:.1f} s (incl. compile); "
          f"first root means: {means[:4]}")


def main():
    # default = order 5, the near-named config-5 scale (order 6 runs the
    # same path, ~8x the host generation and compile time)
    order = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    path = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        tempfile.gettempdir(), f"ver4_o{order}.npz")
    devs = serving_devices()
    if not os.path.exists(path):
        generate(order, path, len(devs) // 2)
    serve(path, devs)


if __name__ == "__main__":
    main()
