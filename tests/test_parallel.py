"""Sharding tests on the virtual 8-device CPU mesh: the multi-chip result
must equal the single-chip result exactly (same-graph equality across
shardings, SURVEY §4)."""
import jax
import numpy as np
import pytest

from feynmandiagram.backends.compile import compile_evaluator
from feynmandiagram.computational_graph import optimize_inplace
from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram.frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
from feynmandiagram.parallel import make_sample_mesh, shard_compiled, make_mc_step

BETA, KF, LAM = 0.5, 1.919, 1.0


def _compiled(loops=2):
    para = DiagPara(type=SigmaDiag, innerLoopNum=loops, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    df = sigma(para, extK, False)
    roots = [row["diagram"] for row in df]
    optimize_inplace(roots)
    return compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                             kF=KF, lam=LAM), para


class TestSampleSharding:
    def test_eight_devices_available(self):
        assert len(jax.devices()) >= 8

    def test_sharded_matches_single_chip(self):
        compiled, para = _compiled()
        mesh = make_sample_mesh(8)
        sharded = shard_compiled(compiled, mesh)
        rng = np.random.default_rng(5)
        batch = 64
        varK = rng.standard_normal((3, para.totalLoopNum, batch))
        varT = rng.random((para.totalLoopNum, batch)) * BETA
        single = np.asarray(compiled(varK, varT))
        multi = np.asarray(sharded(varK, varT))
        np.testing.assert_allclose(multi, single, rtol=1e-12)

    def test_mc_step_runs_and_reduces(self):
        compiled, para = _compiled()
        mesh = make_sample_mesh(8)
        step = make_mc_step(compiled, mesh, beta=BETA)
        key = jax.random.PRNGKey(0)
        means = np.asarray(step(key, 16))
        assert means.shape[0] == len(compiled.lowered.root_slots)
        assert np.all(np.isfinite(means))


class TestGraphSharding:
    def test_graph_sharded_matches_single(self):
        """Level-partitioned evaluation across 8 devices equals single-chip."""
        import random
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.computational_graph import Graph
        import sys, os
        sys.path.insert(0, os.path.dirname(__file__))
        from test_lowering import random_dag

        rng = random.Random(21)
        leaves = [Graph([], properties=("leaf", i)) for i in range(8)]
        roots = [random_dag(rng, leaves, depth=5) for _ in range(4)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        lowered = lower(roots, leafmap, sum_mode="bucketed", max_sum_arity=8)

        vals = np.asarray([[rng.uniform(0.5, 1.5) for _ in range(16)]
                           for _ in range(8)])
        single = np.asarray(make_evaluator(lowered)(vals))

        mesh = make_sample_mesh(8, axis_name="graph")
        sharded_fn = make_graph_sharded_evaluator(lowered, mesh)
        multi = np.asarray(sharded_fn(vals))
        np.testing.assert_allclose(multi, single, rtol=1e-10, atol=1e-12)

    def test_graph_sharded_parquet_sigma(self):
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.backends.compile import leafmap_of

        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          SigmaDiag, sigma)
        from feynmandiagram.computational_graph import optimize_inplace
        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots)
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="bucketed")

        rng = np.random.default_rng(9)
        n_leaf = lowered.num_leaves - len(lowered.const_slots)
        vals = rng.uniform(0.5, 1.5, (n_leaf, 8))
        from feynmandiagram.ops import make_evaluator
        single = np.asarray(make_evaluator(lowered)(vals))
        mesh = make_sample_mesh(4, axis_name="graph")
        multi = np.asarray(make_graph_sharded_evaluator(lowered, mesh)(vals))
        np.testing.assert_allclose(multi, single, rtol=1e-10)

    def test_graph_sharded_fused_matches_single(self):
        """Memory-partitioned sharding of the production fused mode."""
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.backends.compile import leafmap_of

        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          SigmaDiag, sigma)
        from feynmandiagram.computational_graph import optimize_inplace
        para = DiagPara(type=SigmaDiag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots, level=1)
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="fused", cse=True,
                        reuse_slots=False)

        rng = np.random.default_rng(11)
        n_leaf = lowered.num_leaves - len(lowered.const_slots)
        vals = rng.uniform(0.5, 1.5, (n_leaf, 8))
        single = np.asarray(make_evaluator(lowered)(vals))
        mesh = make_sample_mesh(8, axis_name="graph")
        sharded = make_graph_sharded_evaluator(lowered, mesh)
        multi = np.asarray(sharded(vals))
        np.testing.assert_allclose(multi, single, rtol=1e-10)
        # the point of the design: per-device buffer strictly smaller than
        # the full single-chip buffer, and boundary traffic is logged
        # (tiny graph: per-bucket padding keeps the ratio well above 1/8;
        # the order-6 memory-scaling check is benchmarks/certify_sharded.py)
        assert sharded.stats.local_slots < sharded.stats.full_slots // 2
        assert len(sharded.stats.halo_rows_per_level) == lowered.num_levels + 1
        assert sharded.stats.halo_bytes_per_sample() > 0

    def test_local_reuse_and_ownership_options(self):
        """Per-device slot reuse and ownership balancing:
        every (local_reuse, interleave) combination must equal single-chip,
        reuse must shrink the per-device buffer toward live_slots/n, and
        the auto-pick must choose the lower-traffic ownership."""
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.backends.compile import leafmap_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lm = leafmap_of(roots)
        low_full = lower(roots, lm, sum_mode="fused", cse=True,
                         reuse_slots=False)
        live = lower(roots, lm, sum_mode="fused", cse=True,
                     reuse_slots=True).num_slots
        nl = low_full.num_leaves - len(low_full.const_slots)
        vals = np.random.default_rng(2).uniform(0.5, 1.5, (nl, 8))
        single = np.asarray(make_evaluator(low_full)(vals))
        mesh = make_sample_mesh(8, axis_name="graph")
        stats = {}
        for reuse in (False, True):
            for il in (False, True, None):
                g = make_graph_sharded_evaluator(low_full, mesh,
                                                 local_reuse=reuse,
                                                 interleave=il)
                np.testing.assert_allclose(np.asarray(g(vals)), single,
                                           rtol=1e-8, atol=1e-10)
                stats[(reuse, il)] = g.stats
        # reuse shrinks the device buffer toward live/n (tile padding keeps
        # it above the ideal live/8 = {live//8} on this small graph)
        assert stats[(True, None)].local_slots < live / 4
        assert stats[(True, None)].local_slots < stats[(False, None)].local_slots
        # auto-pick <= both fixed layouts, and part of the halo is early
        # (exchangeable while the previous level computes)
        auto = sum(stats[(True, None)].halo_rows_per_level)
        assert auto <= min(sum(stats[(True, False)].halo_rows_per_level),
                           sum(stats[(True, True)].halo_rows_per_level))
        assert 0.1 < stats[(True, None)].early_share < 0.9

    def test_graph_sharded_reuse_slots_rejected(self):
        """Slot recycling breaks single-assignment ownership: must raise."""
        import pytest
        from feynmandiagram.ops import lower
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.backends.compile import leafmap_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          SigmaDiag, sigma)
        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        roots = [row["diagram"] for row in sigma(para, extK, False)]
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="fused", reuse_slots=True)
        mesh = make_sample_mesh(4, axis_name="graph")
        with pytest.raises(ValueError, match="reuse_slots"):
            make_graph_sharded_evaluator(lowered, mesh)

    def test_graph_sharded_tile_layout(self):
        """layout='tile' keeps the per-device buffer and halos in tile-row
        form (the sharded analog of ops.evaluator._eval_levels_tile); must
        equal the flat sharded layout and single chip."""
        import jax.numpy as jnp
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.backends.compile import leafmap_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          SigmaDiag, sigma)
        from feynmandiagram.computational_graph import optimize_inplace
        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        roots = [r["diagram"] for r in sigma(para, extK, False)]
        optimize_inplace(roots, level=1)
        lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True,
                        reuse_slots=False)
        nl = lowered.num_leaves - len(lowered.const_slots)
        vals = np.random.default_rng(17).uniform(
            0.5, 1.5, (nl, 1024)).astype(np.float32)
        single = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                           layout="flat")(vals))
        mesh = make_sample_mesh(4, axis_name="graph")
        for layout in ("flat", "tile"):
            g = make_graph_sharded_evaluator(lowered, mesh, dtype=jnp.float32,
                                             layout=layout)
            np.testing.assert_allclose(np.asarray(g(vals)), single,
                                       rtol=2e-5, atol=1e-6), layout

    def test_graph_sharded_mc_step_2d(self):
        """Production config-5 shape: on-device sampling + leaf kernels +
        graph-sharded evaluation on a (graph x batch) mesh must reproduce
        the single-chip estimator with the same PRNG schedule exactly."""
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.ops.leaf_eval import (leaf_tables_from_lowered,
                                                      make_leaf_evaluator)
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_mc_step
        from feynmandiagram.backends.compile import leafmap_of, leaf_graphs_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace

        para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lm = leafmap_of(roots)
        lowered = lower(roots, lm, sum_mode="fused", cse=True,
                        reuse_slots=False)
        tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                          para.totalLoopNum)

        BETA2, KF2, LAM2 = 0.5, 1.919, 1.0
        devices = np.asarray(jax.devices()[:8]).reshape(4, 2)
        mesh = Mesh(devices, ("graph", "batch"))
        step = make_graph_sharded_mc_step(lowered, tables, mesh, beta=BETA2,
                                          kF=KF2, lam=LAM2)
        key = jax.random.PRNGKey(42)
        bpd, iters = 8, 3
        means = np.asarray(step(key, bpd, iters))
        assert step.stats.local_slots < step.stats.full_slots

        # single-chip reference with the identical PRNG schedule
        leaf_fn = make_leaf_evaluator(tables, beta=BETA2, kF=KF2, lam=LAM2,
                                      layout="flat")
        ev = make_evaluator(lowered)
        max_loop = tables.loop_basis.shape[1]
        num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
        n_batch = mesh.shape["batch"]
        acc = np.zeros(len(lowered.root_slots))
        for b in range(n_batch):
            for i in range(iters):
                k = jax.random.fold_in(jax.random.fold_in(key, b), i)
                k1, k2 = jax.random.split(k)
                vk = jax.random.normal(k1, (3, max_loop, bpd))
                vt = jax.random.uniform(k2, (num_tau, bpd)) * BETA2
                acc += np.asarray(ev(leaf_fn(vk, vt))).sum(axis=1)
        ref = acc / (n_batch * iters * bpd)
        np.testing.assert_allclose(means, ref, rtol=1e-10, atol=1e-12)

    def test_lower_sharded_best_picks_min_footprint(self):
        """lower_sharded_best must return the schedule whose sharded plan
        has the fewest per-device slots (halo rows break ties) — the
        generate-once selection certify_sharded.py and the config-5
        example rely on (round 5; ALAP wins orders 3-4, ASAP wins 5-6)."""
        from feynmandiagram.ops import lower
        from feynmandiagram.parallel.graph_shard import (
            _resolve_plan, lower_sharded_best)
        from feynmandiagram.backends.compile import leafmap_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace

        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lm = leafmap_of(roots)
        stats = {}
        for sched in ("alap", "asap"):
            low = lower(roots, lm, sum_mode="fused", cse=True,
                        reuse_slots=False, schedule=sched)
            _, st, *_ = _resolve_plan(low, 8, None, True)
            stats[sched] = (st.local_slots, sum(st.halo_rows_per_level))
        best_low, best_sched = lower_sharded_best(roots, lm, 8)
        assert stats[best_sched] == min(stats.values())
        _, st_best, *_ = _resolve_plan(best_low, 8, None, True)
        assert (st_best.local_slots,
                sum(st_best.halo_rows_per_level)) == stats[best_sched]

    def test_graph_sharded_mc_step_2d_order5(self):
        """BASELINE config 5 SERVING at its named scale:
        the graph-sharded MC step — on-device sampling + leaf kernels +
        halo-exchanged evaluation + pmean on the 2-D (graph x batch) mesh —
        at ORDER 5, equal to the single-chip estimator under the identical
        PRNG schedule.  (Order 6 runs the same path via
        benchmarks/certify_sharded.py; the anchor is BASELINE config 5's
        'order-6 ver4 across hosts' wording.)"""
        from jax.sharding import Mesh
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.ops.leaf_eval import (leaf_tables_from_lowered,
                                                      make_leaf_evaluator)
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_mc_step
        from feynmandiagram.backends.compile import leafmap_of, leaf_graphs_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace

        para = DiagPara(type=Ver4Diag, innerLoopNum=5, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lm = leafmap_of(roots)
        lowered = lower(roots, lm, sum_mode="fused", cse=True,
                        reuse_slots=False)
        tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                          para.totalLoopNum)

        BETA5, KF5, LAM5 = 0.5, 1.919, 1.0
        devices = np.asarray(jax.devices()[:8]).reshape(4, 2)
        mesh = Mesh(devices, ("graph", "batch"))
        step = make_graph_sharded_mc_step(lowered, tables, mesh, beta=BETA5,
                                          kF=KF5, lam=LAM5)
        key = jax.random.PRNGKey(55)
        bpd, iters = 4, 2
        means = np.asarray(step(key, bpd, iters))
        assert step.stats.local_slots < step.stats.full_slots / 4

        leaf_fn = make_leaf_evaluator(tables, beta=BETA5, kF=KF5, lam=LAM5,
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
                vt = jax.random.uniform(k2, (num_tau, bpd)) * BETA5
                acc += np.asarray(ev(leaf_fn(vk, vt))).sum(axis=1)
        ref = acc / (mesh.shape["batch"] * iters * bpd)
        np.testing.assert_allclose(means, ref, rtol=1e-10, atol=1e-12)

    def test_graph_sharded_2d_mesh(self):
        """2-D (graph x batch) mesh: slot partition + sample sharding."""
        from jax.sharding import Mesh
        from feynmandiagram.ops import lower, make_evaluator
        from feynmandiagram.parallel.graph_shard import make_graph_sharded_evaluator
        from feynmandiagram.backends.compile import leafmap_of
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          SigmaDiag, sigma)
        from feynmandiagram.computational_graph import optimize_inplace
        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        roots = [row["diagram"] for row in sigma(para, extK, False)]
        optimize_inplace(roots)
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="fused", reuse_slots=False)

        rng = np.random.default_rng(13)
        n_leaf = lowered.num_leaves - len(lowered.const_slots)
        vals = rng.uniform(0.5, 1.5, (n_leaf, 16))
        single = np.asarray(make_evaluator(lowered)(vals))
        devices = np.asarray(jax.devices()[:8]).reshape(4, 2)
        mesh = Mesh(devices, ("graph", "batch"))
        sharded = make_graph_sharded_evaluator(lowered, mesh,
                                               batch_axis="batch")
        multi = np.asarray(sharded(vals))
        np.testing.assert_allclose(multi, single, rtol=1e-10)
