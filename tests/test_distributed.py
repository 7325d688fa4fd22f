"""Multi-controller bring-up test: two real processes, one global mesh.

Exercises utils.distributed.initialize_distributed the way a host process
of a multi-host cluster would (SURVEY §5.8): each process owns one CPU
device, the global mesh spans both, and a psum over the mesh reduces across
process boundaries (Gloo collectives on CPU).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = """
import sys
proc_id = int(sys.argv[1])
from feynmandiagram.utils.distributed import initialize_distributed
initialize_distributed("localhost:{port}", 2, proc_id)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()
from jax import shard_map
mesh = Mesh(np.asarray(jax.devices()), ("x",))
f = jax.jit(shard_map(lambda a: jax.lax.psum(a, "x"),
                      mesh=mesh, in_specs=P("x"), out_specs=P()))
out = np.asarray(f(jnp.arange(2, dtype=jnp.float32)))
assert float(out[0]) == 1.0, out  # 0 + 1
print("proc", proc_id, "ok")
"""


@pytest.mark.timeout(180)
def test_two_process_psum(tmp_path):
    port = 29581
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    script = _WORKER.format(port=port)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=150)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} ok" in out


_GRAPH_SHARD_WORKER = """
import sys
proc_id = int(sys.argv[1])
from feynmandiagram.utils.distributed import initialize_distributed
initialize_distributed("localhost:{port}", 2, proc_id)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()
assert len(jax.local_devices()) == 4

from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  Ver4Diag, vertex4)
from feynmandiagram.computational_graph import optimize_inplace
from feynmandiagram.ops import lower, make_evaluator
from feynmandiagram.backends.compile import leafmap_of
from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator

# identical deterministic generation in both processes (fresh uid space)
para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                filter=(NoHartree,),
                interaction=(Interaction(ChargeCharge, Instant),))
roots = [row["diagram"] for row in vertex4(para)]
optimize_inplace(roots, level=1)
lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True,
                reuse_slots=False)
nl = lowered.num_leaves - len(lowered.const_slots)
batch = 8
vals = np.random.default_rng(23).uniform(0.5, 1.5, (nl, batch))

# global 8-device mesh spanning both processes: the per-level halo
# all_gathers cross the process boundary (the DCN path on a real pod)
mesh = Mesh(np.asarray(jax.devices()), ("graph",))
g = make_graph_sharded_evaluator(lowered, mesh, dtype=jnp.float64)
rep = NamedSharding(mesh, P())
gvals = jax.make_array_from_process_local_data(rep, vals)
out = g(gvals)
assert out.sharding.is_fully_replicated
multi = np.asarray(jax.device_get(out.addressable_data(0)))

single = np.asarray(make_evaluator(
    lowered, dtype=np.float64,
    jit=False)(vals))  # local single-device reference on this process
np.testing.assert_allclose(multi, single, rtol=1e-12, atol=1e-14)
assert g.stats.local_slots < g.stats.full_slots
print("proc", proc_id, "graphshard ok")
"""


_MC_STEP_WORKER = """
import sys
proc_id = int(sys.argv[1])
from feynmandiagram.utils.distributed import initialize_distributed
initialize_distributed("localhost:{port}", 2, proc_id)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
assert jax.process_count() == 2 and len(jax.devices()) == 4

from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  Ver4Diag, vertex4)
from feynmandiagram.computational_graph import optimize_inplace
from feynmandiagram.ops import lower, make_evaluator
from feynmandiagram.ops.leaf_eval import (leaf_tables_from_lowered,
                                              make_leaf_evaluator)
from feynmandiagram.backends.compile import leafmap_of, leaf_graphs_of
from feynmandiagram.parallel.graph_shard import make_graph_sharded_mc_step

para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True,
                filter=(NoHartree,),
                interaction=(Interaction(ChargeCharge, Instant),))
roots = [row["diagram"] for row in vertex4(para)]
optimize_inplace(roots, level=1)
lm = leafmap_of(roots)
lowered = lower(roots, lm, sum_mode="fused", cse=True, reuse_slots=False)
tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                  para.totalLoopNum)

# 2x2 (graph x batch) mesh across the two processes: the per-level halo
# all_gathers AND the final pmean both cross the process boundary
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("graph", "batch"))
step = make_graph_sharded_mc_step(lowered, tables, mesh, beta=0.5,
                                  kF=1.919, lam=1.0)
key = jax.random.PRNGKey(77)
bpd, iters = 4, 2
out = step(key, bpd, iters)
means = np.asarray(jax.device_get(out.addressable_data(0)))

# single-chip estimator, identical PRNG schedule (computed locally)
leaf_fn = make_leaf_evaluator(tables, beta=0.5, kF=1.919, lam=1.0,
                              layout="flat")
ev = make_evaluator(lowered)
max_loop = tables.loop_basis.shape[1]
num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
acc = np.zeros(len(lowered.root_slots))
for b in range(mesh.shape["batch"]):
    for i in range(iters):
        k = jax.random.fold_in(jax.random.fold_in(key, b), i)
        k1, k2 = jax.random.split(k)
        vk = jax.random.normal(k1, (3, max_loop, bpd))
        vt = jax.random.uniform(k2, (num_tau, bpd)) * 0.5
        acc += np.asarray(ev(leaf_fn(vk, vt))).sum(axis=1)
ref = acc / (mesh.shape["batch"] * iters * bpd)
np.testing.assert_allclose(means.ravel(), ref, rtol=1e-10, atol=1e-12)
print("proc", proc_id, "mcstep ok")
"""


@pytest.mark.timeout(900)
def test_two_process_graph_sharded_mc_step(tmp_path):
    """The config-5 SERVING shape across real process boundaries: the
    graph-sharded MC step (on-device sampling + leaf kernels +
    halo-exchanged eval + pmean) on a 2x2 mesh spanning 2 processes,
    PRNG-schedule-equal to the single-chip estimator.  Completes the
    cross-process story: the evaluator test below covers the halo path,
    this covers the full production step including the cross-process
    pmean."""
    port = 29583
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    script = _MC_STEP_WORKER.format(port=port)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=870)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} mcstep ok" in out


@pytest.mark.timeout(900)
def test_two_process_graph_sharded_evaluator(tmp_path):
    """Cross-process graph sharding: 2 real processes x 4
    virtual CPU devices each, one global 8-device mesh, the memory-
    partitioned evaluator on an order-3 vertex-4 — per-level halo
    all_gathers cross the process boundary; result equals the
    single-process evaluator exactly (f64)."""
    port = 29582
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    script = _GRAPH_SHARD_WORKER.format(port=port)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=870)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} graphshard ok" in out
