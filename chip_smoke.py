"""Smoke check of the main path on an NVIDIA GPU.

One card (no arguments): the order-4 Gamma4 model (parquet ``vertex4``,
innerLoopNum=4, NoHartree, ChargeCharge/Instant) through the user's path —
``optimize_inplace(level=1)`` -> ``compile_evaluator`` (lowering, leaf
tables, jitted leaf + graph phases) -> the on-device MC loop of
``benchmarks/_mc_bench.py`` at batch 2048 in float32 — then the timed
evaluator against the plain references at the full order-4 graph:

  (a) leaf phase, f32 on the card vs the numpy f64 leaf reference
      (``models/reference.py``): elementwise relative error, divided by
      1 + |ln|value|| (the f32 error of exp(x) grows with |x|), <= 1e-5;
  (b) root weights, f32 on the card vs the host interpreter ``eval_graph``
      in f64 on 8 samples, error per root relative to that root's largest
      |value| <= 5e-4 (the f32-storage bound of docs/conventions.md); the
      same bound for f32 vs f64 on the card over the whole batch;
  (c) root weights, f64 on the card vs ``eval_graph``, rtol 1e-9 and
      atol 1e-12.

``--four``: only the two multi-device paths, on four cards, each against
the single-card estimator under the identical PRNG schedule — sample-axis
data parallelism (``make_mc_step``, 4-card mesh) and config-5 serving
(``make_graph_sharded_mc_step``, 2x2 ("graph", "batch") mesh).

Every phase raises on failure; the last line, printed only when all passed,
is ``{"ok": true, "device": {...}}``.  Anything but a GPU is refused.

Usage: python chip_smoke.py [--four]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

BETA, KF, LAM = 0.5, 1.919, 1.0
ORDER, BATCH, MC_ITERS, N_HOST = 4, 2048, 50, 8
# f32 rounding gives ~1e-6 per unit of |ln G|; TF32 momenta give ~1e-3
LEAF_RTOL = 1e-5
ROOT_F32_TOL = 5e-4       # f32 storage error per root, relative to its scale
F64_RTOL, F64_ATOL = 1e-9, 1e-12
# Two f32 estimators of the same samples that sum in different orders (one
# card against a mesh) each lie within ROOT_F32_TOL * scale of the exact
# value per sample, so their means differ by at most twice that.
MESH_TOL = 2 * ROOT_F32_TOL


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok, what) -> None:
    """Fail the phase (raise, under ``python -O`` too) unless ``ok``."""
    if not ok:
        raise AssertionError(what)


def build_roots(order: int):
    """Order-``order`` Gamma4 roots, optimized; returns (roots, para, times)."""
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  Ver4Diag, vertex4)

    t0 = time.perf_counter()
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para)]
    t1 = time.perf_counter()
    optimize_inplace(roots, level=1)
    t2 = time.perf_counter()
    return roots, para, {"generate_s": t1 - t0, "optimize_s": t2 - t1}


def compile_f(roots, para, dtype, **kw):
    from feynmandiagram.backends.compile import compile_evaluator

    return compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                             kF=KF, lam=LAM, dtype=dtype, **kw)


def draw_samples(para, batch: int, seed: int = 0):
    """A fixed float32 sample batch (varK [3, loops, batch], varT)."""
    rng = np.random.default_rng(seed)
    varK = rng.standard_normal((3, para.totalLoopNum, batch)).astype(np.float32)
    varT = (rng.random((para.totalTauNum, batch)) * BETA).astype(np.float32)
    return varK, varT


def _root_errors(got, ref, axis_scale):
    """Per-root max |got - ref| over samples, over the root's max |ref|."""
    scale = np.abs(axis_scale).max(axis=1)
    diff = np.abs(got - ref).max(axis=1)
    return np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0), diff)


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def check_correctness(roots, para, *, batch: int, n_host: int, compiled32=None):
    """Phases (a)-(c) on JAX's default device.  Returns the measured errors;
    raises AssertionError when one exceeds its bound."""
    import jax
    import jax.numpy as jnp

    from feynmandiagram.backends.compile import leafmap_of
    from feynmandiagram.computational_graph import eval_graph
    from feynmandiagram.models.reference import np_leaf_values

    if compiled32 is None:
        compiled32 = compile_f(roots, para, jnp.float32)
    compiled64 = compile_f(roots, para, jnp.float64)
    varK, varT = draw_samples(para, batch)
    varK64, varT64 = varK.astype(np.float64), varT.astype(np.float64)
    leafmap = leafmap_of(roots)
    nl = len(leafmap)
    errs = {}

    # (a) leaf phase
    ref_leaf = np_leaf_values(roots, leafmap, varK64, varT64,
                              beta=BETA, kF=KF, lam=LAM)
    leaf32, dt = _timed(jax.jit(compiled32.leaf_fn), varK, varT)
    leaf32 = np.asarray(leaf32, np.float64).reshape(nl, batch)
    rel = np.abs(leaf32 - ref_leaf) / np.abs(ref_leaf)
    # G = exp(-x)...: f32 evaluation error grows with x = |ln G|
    errs["leaf_f32_rel"] = float(rel.max())
    errs["leaf_f32_rel_per_log"] = float(
        (rel / (1 + np.abs(np.log(np.abs(ref_leaf))))).max())
    log(f"(a) leaf f32 vs numpy f64, {nl} leaves x {batch} samples: max rel "
        f"err / (1 + |ln|ref||) {errs['leaf_f32_rel_per_log']:.3e} (bound "
        f"{LEAF_RTOL:.0e}); max rel err {errs['leaf_f32_rel']:.3e}; compile+"
        f"run {dt:.2f} s")
    check(errs["leaf_f32_rel_per_log"] <= LEAF_RTOL, errs)

    # host interpreter on the first n_host samples, f64 leaf values
    host = np.asarray([[eval_graph(r, leafmap, list(ref_leaf[:, b]))
                        for b in range(n_host)] for r in roots])

    # (b) roots in f32
    r32, dt32 = _timed(compiled32.fn, varK, varT)
    r32 = np.asarray(r32, np.float64)
    errs["root_f32_vs_host"] = float(
        _root_errors(r32[:, :n_host], host, host).max())
    log(f"(b) roots f32 vs host eval_graph f64 ({len(roots)} roots x {n_host} "
        f"samples): max err/root scale {errs['root_f32_vs_host']:.3e} "
        f"(bound {ROOT_F32_TOL:.0e}), compile+run {dt32:.2f} s")
    check(errs["root_f32_vs_host"] <= ROOT_F32_TOL, errs)

    # (c) roots in f64
    r64, dt64 = _timed(compiled64.fn, varK64, varT64)
    r64 = np.asarray(r64)
    viol = np.abs(r64[:, :n_host] - host) / (F64_ATOL + F64_RTOL * np.abs(host))
    errs["root_f64_vs_host_max_rel"] = float(
        (np.abs(r64[:, :n_host] - host) / np.maximum(np.abs(host), 1e-300)).max())
    errs["root_f64_vs_host_violation"] = float(viol.max())
    log(f"(c) roots f64 vs host eval_graph f64: max rel err "
        f"{errs['root_f64_vs_host_max_rel']:.3e}, max |d|/(atol+rtol|ref|) "
        f"{errs['root_f64_vs_host_violation']:.3e} (bound 1 at rtol "
        f"{F64_RTOL:.0e}, atol {F64_ATOL:.0e}), compile+run {dt64:.2f} s")
    np.testing.assert_allclose(r64[:, :n_host], host, rtol=F64_RTOL,
                               atol=F64_ATOL)

    errs["root_f32_vs_f64"] = float(_root_errors(r32, r64, r64).max())
    log(f"(b) roots f32 vs f64 on the device over all {batch} samples: "
        f"max err/root scale {errs['root_f32_vs_f64']:.3e} "
        f"(bound {ROOT_F32_TOL:.0e})")
    check(errs["root_f32_vs_f64"] <= ROOT_F32_TOL, errs)
    return errs


def run_mc(compiled32, para, *, batch: int, iters: int):
    """The on-device MC loop: compile, memory analysis, run, finite sums."""
    import jax
    import jax.numpy as jnp
    from _mc_bench import make_mc_chunk, time_mc_chunk

    mc_chunk = make_mc_chunk(compiled32.fn, n_loop=para.totalLoopNum,
                             num_tau=para.totalTauNum, batch=batch,
                             n_roots=len(compiled32.lowered.root_slots),
                             dtype=jnp.float32, iters=iters, beta=BETA)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    step = mc_chunk.lower(key).compile()
    compile_s = time.perf_counter() - t0
    ma = step.memory_analysis()
    mem = {k: getattr(ma, k) for k in dir(ma)
           if k.endswith("_in_bytes") and isinstance(getattr(ma, k), int)}
    sums, first_s = _timed(step, key)
    sums = np.asarray(sums)
    check(sums.shape == (len(compiled32.lowered.root_slots),), sums.shape)
    check(np.all(np.isfinite(sums)), "non-finite MC root sums")
    sps = time_mc_chunk(step, batch=batch, iters=iters, reps=3)
    return {"compile_s": compile_s, "first_run_s": first_s,
            "memory_analysis": mem, "samples_per_s": sps,
            "n_roots": len(sums)}


def _device_facts():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def smoke_one() -> dict:
    import jax
    import jax.numpy as jnp

    from feynmandiagram.native import native_available

    log(f"native graphcore library: "
        f"{'built' if native_available() else 'NOT built (numpy fallback)'}")
    roots, para, times = build_roots(ORDER)
    t0 = time.perf_counter()
    compiled32 = compile_f(roots, para, jnp.float32)
    times["lower_s"] = time.perf_counter() - t0
    low = compiled32.lowered
    log(f"order-{ORDER} Gamma4: {len(roots)} roots, {low.num_slots} slots, "
        f"{low.num_edges} edges, {len(low.levels)} levels; host "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))

    mc = run_mc(compiled32, para, batch=BATCH, iters=MC_ITERS)
    log(f"MC loop f32 batch {BATCH} x {MC_ITERS} iters: compile "
        f"{mc['compile_s']:.2f} s, first run {mc['first_run_s']:.3f} s, "
        f"{mc['n_roots']} root sums finite")
    log(f"MC loop memory_analysis: {json.dumps(mc['memory_analysis'])}")
    log(f"weight buffer {low.num_slots} x {BATCH} x 4 B = "
        f"{low.num_slots * BATCH * 4} bytes")
    log(f"MC loop samples/s (median of 3, not a benchmark): "
        f"{mc['samples_per_s']:.1f}")

    errs = check_correctness(roots, para, batch=BATCH, n_host=N_HOST,
                             compiled32=compiled32)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    return {"errors": errs, "mc": mc}


def check_four(roots, para, devices, *, bpd: int, iters: int) -> dict:
    """Both multi-device paths on ``devices[:4]``, each against the
    single-card estimator (``compile_evaluator``'s jitted evaluator on JAX's
    default device) under the identical PRNG schedule.  Returns per-path max
    error / root scale."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from feynmandiagram.backends.compile import leaf_graphs_of, leafmap_of
    from feynmandiagram.ops.leaf_eval import leaf_tables_from_lowered
    from feynmandiagram.parallel import (make_graph_sharded_mc_step,
                                         make_mc_step, make_sample_mesh)
    from feynmandiagram.parallel.graph_shard import lower_sharded_best

    devices = list(devices)[:4]
    check(len({d.id for d in devices}) == 4, devices)
    f32 = jnp.float32
    key = jax.random.PRNGKey(11)
    out = {}

    def on_four(arr, name):
        got = {d.id for d in arr.sharding.device_set}
        check(got == {d.id for d in devices}, (name, got))

    def per_device_peaks():
        stats = [d.memory_stats() for d in devices]
        return [s.get("peak_bytes_in_use", 0) if s else None for s in stats]

    # 1. sample-axis data parallelism on a 4-card mesh
    compiled = compile_f(roots, para, f32)
    mesh = make_sample_mesh(devices=devices)
    step = jax.jit(make_mc_step(compiled, mesh, beta=BETA, dtype=f32),
                   static_argnums=1)
    means = step(key, bpd)
    on_four(means, "make_mc_step")
    means = np.asarray(means, np.float64)
    num_tau = int(max(compiled.tables.tau_in.max(),
                      compiled.tables.tau_out.max()))
    single = compiled.fn
    ref, scale = [], 0.0
    for d in range(len(devices)):
        k1, k2 = jax.random.split(jax.random.fold_in(key, d))
        vk = jax.random.normal(k1, (3, para.totalLoopNum, bpd), f32)
        vt = jax.random.uniform(k2, (num_tau, bpd), f32) * BETA
        r = np.asarray(single(vk, vt), np.float64)
        ref.append(r.mean(axis=1))
        scale = np.maximum(scale, np.abs(r).max(axis=1))
    ref = np.mean(ref, axis=0)
    out["sample_axis"] = float(_root_errors(means[:, None], ref[:, None],
                                            scale[:, None]).max())
    log(f"[four] make_mc_step on {len(devices)} devices, {bpd} samples each: "
        f"max |mesh - single| / root scale {out['sample_axis']:.3e} "
        f"(bound {MESH_TOL:.0e}); peak bytes per device {per_device_peaks()}")
    check(out["sample_axis"] <= MESH_TOL, out)

    # 2. config-5 serving: graph-sharded MC step on a 2x2 (graph, batch) mesh
    leafmap = leafmap_of(roots)
    lowered, sched = lower_sharded_best(roots, leafmap, 2)
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                      para.totalLoopNum)
    mesh2 = Mesh(np.asarray(devices).reshape(2, 2), ("graph", "batch"))
    gstep = make_graph_sharded_mc_step(lowered, tables, mesh2, beta=BETA,
                                       kF=KF, lam=LAM, dtype=f32)
    gmeans = gstep(key, bpd, iters)
    on_four(gmeans, "make_graph_sharded_mc_step")
    gmeans = np.asarray(gmeans, np.float64)
    # the sharded step draws (3, max_loop, bpd) / (num_tau, bpd) samples,
    # the same shapes the single-card evaluator takes
    check(tables.loop_basis.shape[1] == para.totalLoopNum, "loop count")
    check(int(max(tables.tau_in.max(), tables.tau_out.max())) == num_tau,
          "tau count")
    check(list(lowered.root_slots.shape) == [len(roots)], "root count")
    acc, scale = 0.0, 0.0
    n_batch = mesh2.shape["batch"]
    for b in range(n_batch):
        for i in range(iters):
            k = jax.random.fold_in(jax.random.fold_in(key, b), i)
            k1, k2 = jax.random.split(k)
            vk = jax.random.normal(k1, (3, para.totalLoopNum, bpd), f32)
            vt = jax.random.uniform(k2, (num_tau, bpd), f32) * BETA
            r = np.asarray(single(vk, vt), np.float64)
            acc = acc + r.sum(axis=1)
            scale = np.maximum(scale, np.abs(r).max(axis=1))
    gref = acc / (n_batch * iters * bpd)
    out["graph_sharded"] = float(_root_errors(gmeans[:, None], gref[:, None],
                                              scale[:, None]).max())
    st = gstep.stats
    log(f"[four] make_graph_sharded_mc_step on a 2x2 (graph, batch) mesh "
        f"(schedule {sched}, {st.local_slots} of {st.full_slots} slots per "
        f"device), {bpd} samples x {iters} iters per batch rank: max |mesh - "
        f"single| / root scale {out['graph_sharded']:.3e} "
        f"(bound {MESH_TOL:.0e}); peak bytes per device {per_device_peaks()}")
    check(out["graph_sharded"] <= MESH_TOL, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the two multi-device paths on four cards")
    args = ap.parse_args(argv)

    import jax

    from feynmandiagram.utils.device import (enable_compile_cache,
                                             gpu_name_and_power_limit,
                                             require_gpu_or_exit)

    devices = require_gpu_or_exit("chip_smoke")
    cache = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    facts = _device_facts()
    log(f"jax {jax.__version__}; device_kind {facts['kind']!r}; "
        f"{facts['count']} device(s); compile cache {cache}")
    # read by nvidia-smi, a child process that stays off JAX
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            raise SystemExit(2)
        roots, para, _ = build_roots(ORDER)
        check_four(roots, para, devices, bpd=BATCH, iters=4)
    else:
        smoke_one()
    print(json.dumps({"ok": True, "device": facts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
