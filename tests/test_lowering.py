"""Lowering + batched evaluator equivalence vs the interpreted host eval.

Oracle strategy per SURVEY.md §7.2 step 2: random DAGs, leaf==1 counts, and
batched evaluation must agree with ``eval_graph`` to float tolerance.
"""
import random

import numpy as np
import pytest

from feynmandiagram.computational_graph import (
    Graph, SUM, PROD, Power, constant_graph, eval_graph, optimize,
)
from feynmandiagram.ops import lower, make_evaluator, evaluate_graphs


def random_dag(rng, leaves, depth=5, fan=3):
    if depth == 0 or rng.random() < 0.25:
        return rng.choice(leaves)
    kind = rng.random()
    if kind < 0.45:
        n = rng.randint(1, fan)
        subs = [random_dag(rng, leaves, depth - 1, fan) for _ in range(n)]
        facs = [rng.choice([1.0, 2.0, -1.5, 0.5]) for _ in range(n)]
        return Graph(subs, subgraph_factors=facs, operator=SUM)
    if kind < 0.85:
        n = rng.randint(2, fan + 3)  # wide prods exercise binarization
        subs, facs, seen = [], [], set()
        for _ in range(n):
            s = random_dag(rng, leaves, depth - 1, fan)
            if id(s) in seen:
                continue
            seen.add(id(s))
            subs.append(s)
            facs.append(rng.choice([1.0, -1.0, 0.5]))
        return Graph(subs, subgraph_factors=facs, operator=PROD)
    sub = random_dag(rng, leaves, depth - 1, fan)
    return Graph([sub], subgraph_factors=[rng.choice([1.0, -2.0])],
                 operator=Power(rng.randint(2, 4)))


class TestLoweringEquivalence:
    @pytest.mark.parametrize("seed", [1, 2, 3, 4])
    def test_random_dag_matches_interpreter(self, seed):
        rng = random.Random(seed)
        leaves = [Graph([], properties=("leaf", i)) for i in range(6)]
        roots = [random_dag(rng, leaves) for _ in range(3)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = [rng.uniform(0.5, 1.5) for _ in range(6)]
        expected = [eval_graph(r, leafmap, vals) for r in roots]
        got = evaluate_graphs(roots, np.asarray(vals), leafmap)
        np.testing.assert_allclose(got[:, 0], expected, rtol=1e-10, atol=1e-9)

    @pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
    def test_random_dag_cse_canonicalization(self, seed):
        """Round-5 hardening: random DAGs with PROPORTIONAL duplicate
        products (same operand multiset, different internal-factor /
        parent-edge coefficient splits, shuffled child order) plus wide
        prods and powers-of-prods — the shapes the canonicalize+second-CSE
        pass rewrites — must evaluate f64-identically with cse on/off."""
        rng = random.Random(seed)
        leaves = [Graph([], properties=("leaf", i)) for i in range(5)]

        def prop_dup_prod():
            ops = [rng.choice(leaves) for _ in range(rng.randint(2, 6))]
            ops = list({id(o): o for o in ops}.values())
            shuffled = list(ops)
            rng.shuffle(shuffled)
            f = rng.choice([0.5, 2.0, -3.0])
            a = Graph(ops, subgraph_factors=[f] + [1.0] * (len(ops) - 1),
                      operator=PROD)
            b = Graph(shuffled,
                      subgraph_factors=[1.0] * (len(shuffled) - 1) + [-f],
                      operator=PROD)
            return a, b

        terms, facs = [], []
        for _ in range(6):
            a, b = prop_dup_prod()
            terms += [a, b]
            facs += [rng.choice([1.0, 2.0]), rng.choice([1.0, -0.5])]
            if rng.random() < 0.4:
                terms.append(Graph([a], operator=Power(rng.randint(2, 3))))
                facs.append(rng.choice([1.0, 3.0]))
        terms.append(random_dag(rng, leaves, depth=4))
        facs.append(1.0)
        roots = [Graph(terms, subgraph_factors=facs, operator=SUM),
                 random_dag(rng, leaves, depth=4)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = [rng.uniform(0.5, 1.5) for _ in range(5)]
        expected = [eval_graph(r, leafmap, vals) for r in roots]
        for cse in (False, True):
            low = lower(roots, leafmap, sum_mode="fused", cse=cse)
            got = np.asarray(make_evaluator(low, dtype=np.float64)(
                np.asarray(vals)))
            np.testing.assert_allclose(got[:, 0], expected, rtol=1e-11,
                                       atol=1e-12), cse

    @pytest.mark.parametrize("seed", [5, 6])
    def test_batched(self, seed):
        rng = random.Random(seed)
        leaves = [Graph([], properties=("leaf", i)) for i in range(4)]
        roots = [random_dag(rng, leaves, depth=4) for _ in range(2)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        batch = 7
        vals = np.array([[rng.uniform(0.5, 1.5) for _ in range(batch)] for _ in range(4)])
        got = evaluate_graphs(roots, vals, leafmap)
        for b in range(batch):
            expected = [eval_graph(r, leafmap, list(vals[:, b])) for r in roots]
            np.testing.assert_allclose(got[:, b], expected, rtol=1e-10, atol=1e-9)

    def test_constants_and_leaf_roots(self):
        g1 = Graph([], properties="x")
        c = constant_graph(5.0)
        s = Graph([g1, c], subgraph_factors=[2.0, 3.0], operator=SUM)
        leafmap = {g1.id: 0}
        got = evaluate_graphs([s, g1], np.asarray([7.0]), leafmap)
        assert got[0, 0] == pytest.approx(2 * 7 + 3 * 5)
        assert got[1, 0] == pytest.approx(7.0)

    def test_power_negative_base(self):
        g1 = Graph([], properties="x")
        p = Graph([g1], subgraph_factors=[2.0], operator=Power(3))
        got = evaluate_graphs([p], np.asarray([-1.5]), {g1.id: 0})
        assert got[0, 0] == pytest.approx(2.0 * (-1.5) ** 3)

    def test_after_optimize(self):
        rng = random.Random(11)
        leaves = [Graph([], properties=("leaf", i)) for i in range(5)]
        roots = [random_dag(rng, leaves) for _ in range(3)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = [rng.uniform(0.5, 1.5) for _ in range(5)]
        expected = [eval_graph(r, leafmap, vals) for r in roots]
        roots_op = optimize(roots, level=1)
        got = evaluate_graphs(roots_op, np.asarray(vals), leafmap)
        np.testing.assert_allclose(got[:, 0], expected, rtol=1e-10, atol=1e-9)

    def test_shared_subgraph_evaluated_once(self):
        x = Graph([], properties="x")
        shared = Graph([x], subgraph_factors=[3.0], operator=Power(2))
        a = Graph([shared, x], operator=PROD)
        b = Graph([shared, shared], subgraph_factors=[1.0, 2.0], operator=SUM)
        lowered = lower([a, b], {x.id: 0})
        # slots: x, shared, a, b -> shared appears once
        assert lowered.num_slots == 4
        f = make_evaluator(lowered)
        out = np.asarray(f(np.asarray([2.0])))
        assert out[0, 0] == pytest.approx(3 * 4 * 2)
        assert out[1, 0] == pytest.approx(3 * 12.0)

    def test_wide_prod_binarization(self):
        leaves = [Graph([], properties=i) for i in range(9)]
        p = Graph(leaves, subgraph_factors=[1.0 + i * 0.1 for i in range(9)],
                  operator=PROD)
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = [1.0 + 0.05 * i for i in range(9)]
        expected = eval_graph(p, leafmap, vals)
        got = evaluate_graphs([p], np.asarray(vals), leafmap)
        assert got[0, 0] == pytest.approx(expected)

    def test_diagram_count_convention(self):
        # leaves == 1 evaluation gives diagram counts (eval.jl default)
        leaves = [Graph([], properties=i) for i in range(3)]
        s = Graph(leaves, subgraph_factors=[1, 1, 1], operator=SUM)
        lowered = lower([s])
        f = make_evaluator(lowered)
        out = np.asarray(f(np.ones((3, 1))))
        assert out[0, 0] == 3.0


class TestBucketedSums:
    @pytest.mark.parametrize("seed", [1, 9])
    def test_bucketed_matches_csr(self, seed):
        rng = random.Random(seed)
        leaves = [Graph([], properties=("leaf", i)) for i in range(6)]
        roots = [random_dag(rng, leaves) for _ in range(3)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = np.asarray([rng.uniform(0.5, 1.5) for _ in range(6)])
        csr = lower(roots, leafmap, sum_mode="csr")
        bucketed = lower(roots, leafmap, sum_mode="bucketed", max_sum_arity=4)
        got_csr = np.asarray(make_evaluator(csr)(vals))
        got_b = np.asarray(make_evaluator(bucketed)(vals))
        np.testing.assert_allclose(got_b, got_csr, rtol=1e-10, atol=1e-12)

    def test_wide_sum_split(self):
        leaves = [Graph([], properties=i) for i in range(40)]
        s = Graph(leaves, subgraph_factors=[float(i + 1) for i in range(40)],
                  operator=SUM)
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = np.arange(1.0, 41.0)
        lowered = lower([s], leafmap, sum_mode="bucketed", max_sum_arity=8)
        out = np.asarray(make_evaluator(lowered)(vals))
        expected = sum((i + 1) * vals[i] for i in range(40))
        assert out[0, 0] == pytest.approx(expected)


class TestFusedMode:
    """sum_mode='fused': the uniform sum-of-products primitive must agree
    with the CSR lowering on arbitrary DAGs and on real parquet graphs."""

    @pytest.mark.parametrize("seed", [1, 2, 7, 11])
    def test_fused_matches_csr_random(self, seed):
        rng = random.Random(seed)
        leaves = [Graph([], properties=("leaf", i)) for i in range(6)]
        roots = [random_dag(rng, leaves) for _ in range(3)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = np.asarray([rng.uniform(0.5, 1.5) for _ in range(6)])
        csr = lower(roots, leafmap, sum_mode="csr")
        fused = lower(roots, leafmap, sum_mode="fused", max_sum_arity=4)
        got_csr = np.asarray(make_evaluator(csr)(vals))
        got_f = np.asarray(make_evaluator(fused)(vals))
        np.testing.assert_allclose(got_f, got_csr, rtol=1e-10, atol=1e-12)

    def test_inlines_fanout1_prods(self):
        """A Sum over two exclusive 2-Prods lowers to a single fused bucket:
        no intermediate slots for the Prods."""
        leaves = [Graph([], properties=i) for i in range(4)]
        p1 = Graph(leaves[:2], subgraph_factors=[2.0, 1.0], operator=PROD)
        p2 = Graph(leaves[2:], subgraph_factors=[1.0, -1.0], operator=PROD)
        s = Graph([p1, p2], subgraph_factors=[1.0, 3.0], operator=SUM)
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        lowered = lower([s], leafmap, sum_mode="fused")
        # one fused bucket holds the whole sum-of-products: no Prod slots,
        # one output node (tile-padded to TILE_ROWS=8 aligned rows)
        (lvl,) = lowered.levels
        (fb,) = lvl.fused
        assert (fb.arity, fb.n_op) == (2, 2)
        assert not lvl.prods and not lvl.pows and not lvl.sum_buckets
        assert lowered.num_slots <= 16  # 5 leaf slots ->8 + 1 node ->8
        vals = np.asarray([1.5, 2.0, 3.0, 4.0])
        out = np.asarray(make_evaluator(lowered)(vals))
        assert out[0, 0] == pytest.approx(2.0 * 1.5 * 2.0 + 3.0 * (3.0 * -4.0))

    def test_shared_prod_not_inlined(self):
        """A Prod read by two Sums keeps its own slot (computed once)."""
        leaves = [Graph([], properties=i) for i in range(2)]
        p = Graph(leaves, subgraph_factors=[1.0, 1.0], operator=PROD)
        s1 = Graph([p, leaves[0]], subgraph_factors=[1.0, 1.0], operator=SUM)
        s2 = Graph([p, leaves[1]], subgraph_factors=[2.0, 1.0], operator=SUM)
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        lowered = lower([s1, s2], leafmap, sum_mode="fused")
        vals = np.asarray([3.0, 5.0])
        out = np.asarray(make_evaluator(lowered)(vals))
        np.testing.assert_allclose(out[:, 0], [15.0 + 3.0, 30.0 + 5.0])

    def test_root_prod_not_inlined(self):
        """A root Prod must keep its slot even if it is also a Sum child."""
        leaves = [Graph([], properties=i) for i in range(2)]
        p = Graph(leaves, subgraph_factors=[1.0, 1.0], operator=PROD)
        s = Graph([p], subgraph_factors=[2.0], operator=SUM)
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        lowered = lower([s, p], leafmap, sum_mode="fused")
        vals = np.asarray([3.0, 5.0])
        out = np.asarray(make_evaluator(lowered)(vals))
        np.testing.assert_allclose(out[:, 0], [30.0, 15.0])

    def test_fused_order2_sigma(self):
        """Order-2 sigma via parquet: fused == csr on physical-ish leaves."""
        from feynmandiagram.frontends import (ChargeCharge, Instant,
                                                  NoHartree)
        from feynmandiagram.frontends.parquet import (DiagPara,
                                                          Interaction,
                                                          SigmaDiag, sigma)
        from feynmandiagram.computational_graph import optimize_inplace

        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        df = sigma(para)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots, level=1)
        from feynmandiagram.backends.compile import leafmap_of
        leafmap = leafmap_of(roots)
        rng = np.random.default_rng(0)
        vals = rng.standard_normal((len(leafmap), 5))
        csr = lower(roots, leafmap, sum_mode="csr", cse=True)
        fused = lower(roots, leafmap, sum_mode="fused", cse=True)
        got_csr = np.asarray(make_evaluator(csr)(vals))
        got_f = np.asarray(make_evaluator(fused)(vals))
        np.testing.assert_allclose(got_f, got_csr, rtol=1e-10, atol=1e-12)
        # Prod inlining removes operand edges (the per-node tile padding of
        # the fused layout can inflate raw slot counts on tiny graphs, so
        # compare edges, which padding does not affect)
        assert fused.num_edges < csr.num_edges
        assert all(not lvl.prods for lvl in fused.levels)


class TestTileLayout:
    def test_tile_matches_flat_order3_ver4(self):
        """layout='tile' ([S, nsub, 128] tile-row buffer, unrolled adds)
        must equal layout='flat' up to summation order, for every bucket
        shape of a real parquet graph (incl. arity > unroll_max)."""
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
        nl = lowered.num_leaves - len(lowered.const_slots)
        vals = np.random.default_rng(5).uniform(0.5, 1.5, (nl, 1024)).astype(np.float32)
        flat = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                         layout="flat")(vals))
        tile = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                         layout="tile")(vals))
        assert tile.shape == flat.shape
        np.testing.assert_allclose(tile, flat, rtol=2e-4, atol=1e-6)

    def test_tile_compensated(self):
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          SigmaDiag, sigma)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=SigmaDiag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        roots = [r["diagram"] for r in sigma(para, extK, False)]
        optimize_inplace(roots, level=1)
        lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
        nl = lowered.num_leaves - len(lowered.const_slots)
        vals = np.random.default_rng(6).uniform(0.5, 1.5, (nl, 1024)).astype(np.float32)
        ref = np.asarray(make_evaluator(lowered, dtype=np.float64,
                                        layout="flat")(vals))
        tile_c = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                           layout="tile", compensated=True)(vals))
        # atol covers the f32 *storage* rounding floor: compensation
        # fixes reduction order, not stored rounding
        np.testing.assert_allclose(tile_c, ref, rtol=2e-5, atol=1e-6)

    @pytest.mark.parametrize("batch", [256, 512])
    def test_tile_partial_sublane_batches(self, batch):
        """Partial tile rows (nsub = batch//128 < 8): the [S, nsub, 128]
        buffer at batch 512/256 must equal the flat layout."""
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
        nl = lowered.num_leaves - len(lowered.const_slots)
        vals = np.random.default_rng(8).uniform(
            0.5, 1.5, (nl, batch)).astype(np.float32)
        flat = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                         layout="flat")(vals))
        tile = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                         layout="tile")(vals))
        np.testing.assert_allclose(tile, flat, rtol=2e-4, atol=1e-6)

    @pytest.mark.parametrize("chunk", [64, 200, 1024])
    def test_chunk_rows_equality(self, chunk):
        """The bucket-chunk size (a pure performance knob, default 256
        tile / 512 flat) never changes results."""
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
        nl = lowered.num_leaves - len(lowered.const_slots)
        vals = np.random.default_rng(9).uniform(
            0.5, 1.5, (nl, 256)).astype(np.float32)
        ref = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                        layout="tile")(vals))
        got = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                        layout="tile",
                                        chunk_rows=chunk)(vals))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-7)

    def test_tile_rejects_bad_dtype_and_batch(self):
        """An explicit layout='tile' request fails loudly (no silent flat
        fallback) for non-4-byte dtypes and non-256-multiple batches
       ."""
        import jax.numpy as jnp
        from feynmandiagram.computational_graph import Graph
        from feynmandiagram.computational_graph.operators import SUM
        leaves = [Graph([], properties=i) for i in range(3)]
        s = Graph(leaves, subgraph_factors=[1.0, 2.0, 3.0], operator=SUM)
        lowered = lower([s], {leaf.id: i for i, leaf in enumerate(leaves)},
                        sum_mode="fused")
        f64 = make_evaluator(lowered, dtype=jnp.float64, layout="tile",
                             jit=False)
        with pytest.raises(ValueError, match="4-byte"):
            f64(np.ones((3, 256)))
        f32 = make_evaluator(lowered, dtype=jnp.float32, layout="tile",
                             jit=False)
        with pytest.raises(ValueError, match="256"):
            f32(np.ones((3, 384), np.float32))

    def test_tile_rejects_non_fused(self):
        import jax.numpy as jnp
        from feynmandiagram.computational_graph import Graph
        from feynmandiagram.computational_graph.operators import SUM
        leaves = [Graph([], properties=i) for i in range(3)]
        s = Graph(leaves, subgraph_factors=[1.0, 2.0, 3.0], operator=SUM)
        lowered = lower([s], {leaf.id: i for i, leaf in enumerate(leaves)},
                        sum_mode="csr")
        with pytest.raises(ValueError, match="tile"):
            make_evaluator(lowered, dtype=jnp.float32, layout="tile")


class TestPrecision:
    def test_f32_vs_f64_order3_ver4(self):
        """Quantify f32 vs f64 error on a real parquet graph
        (SURVEY hard part #4: Prod/Power numerics in reduced precision)."""
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        df = vertex4(para)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots, level=1)
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="bucketed")
        rng = np.random.default_rng(1)
        vals = rng.uniform(0.25, 4.0, (len(leafmap), 16))
        f64 = np.asarray(make_evaluator(lowered, dtype=jnp.float64)(vals))
        f32 = np.asarray(make_evaluator(lowered, dtype=jnp.float32)(
            vals.astype(np.float32)))
        denom = np.maximum(np.abs(f64), 1e-3 * np.abs(f64).max())
        rel = np.abs(f32 - f64) / denom
        assert rel.max() < 5e-4, rel.max()

    def test_bf16_storage_f32_acc(self):
        """bf16-storage mode (half-width weight buffer, f32 accumulation):
        typical outputs stay within ~1% of f64 (bf16 rounding per stored
        level); cancellation-dominated outputs can be off by much more, which
        is why this mode is for fast parameter scans, not final estimates."""
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        df = vertex4(para)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots, level=1)
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="bucketed")
        rng = np.random.default_rng(2)
        vals = rng.uniform(0.25, 4.0, (len(leafmap), 16))
        f64 = np.asarray(make_evaluator(lowered, dtype=jnp.float64)(vals))
        out = make_evaluator(lowered, dtype=jnp.bfloat16,
                             acc_dtype=jnp.float32)(vals.astype(np.float32))
        assert out.dtype == jnp.float32
        mixed = np.asarray(out, np.float64)
        denom = np.maximum(np.abs(f64), 1e-3 * np.abs(f64).max())
        rel = np.abs(mixed - f64) / denom
        assert np.median(rel) < 1e-2, np.median(rel)
        assert rel.max() < 0.5, rel.max()


class TestBucketMerging:
    @pytest.mark.parametrize("threshold", [100, 10000])
    def test_merged_matches_unmerged(self, threshold):
        rng = random.Random(13)
        leaves = [Graph([], properties=("leaf", i)) for i in range(6)]
        roots = [random_dag(rng, leaves) for _ in range(3)]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = np.asarray([rng.uniform(0.5, 1.5) for _ in range(6)])
        base = lower(roots, leafmap, sum_mode="bucketed")
        merged = lower(roots, leafmap, sum_mode="bucketed",
                       merge_threshold=threshold)
        got_base = np.asarray(make_evaluator(base)(vals))
        got_merged = np.asarray(make_evaluator(merged)(vals))
        np.testing.assert_allclose(got_merged, got_base, rtol=1e-10, atol=1e-12)
        n_ops_base = sum(len(l.sum_buckets) + len(l.prods) + len(l.pows)
                         for l in base.levels)
        n_ops_merged = sum(len(l.sum_buckets) + len(l.prods) + len(l.pows)
                           for l in merged.levels)
        assert n_ops_merged <= n_ops_base


class TestCompensatedSummation:
    """Kahan two-sum inside bucket reductions (SURVEY §7.3 item 4): f32
    storage with compensation must beat plain f32 on cancellation-heavy
    sums, approaching the f64 ground truth."""

    def test_cancellation_bucket(self):
        """A single wide Sum with alternating huge/small terms: plain f32
        loses the small terms entirely; compensated f32 recovers them."""
        import jax.numpy as jnp
        from feynmandiagram.computational_graph import Graph

        # sum_i (1e6 - 1e6 + 1) repeated: true value = n_triples
        leaves, factors = [], []
        n_triples = 16
        big = Graph([], properties=("leaf", "big"))
        small = Graph([], properties=("leaf", "small"))
        sub = []
        fac = []
        for _ in range(n_triples):
            sub.extend([big, big, small])
            fac.extend([1.0e6, -1.0e6, 1.0])
        root = Graph(sub, subgraph_factors=fac)
        leafmap = {big.id: 0, small.id: 1}
        lowered = lower([root], leafmap, sum_mode="fused", max_sum_arity=64)
        vals64 = np.asarray([[1.0], [1.0]])
        vals32 = vals64.astype(np.float32)

        f64 = float(np.asarray(make_evaluator(lowered, dtype=jnp.float64)(vals64))[0, 0])
        plain = float(np.asarray(make_evaluator(lowered, dtype=jnp.float32)(vals32))[0, 0])
        kahan = float(np.asarray(make_evaluator(
            lowered, dtype=jnp.float32, compensated=True)(vals32))[0, 0])
        assert f64 == n_triples
        assert kahan == pytest.approx(f64, abs=1e-3)
        assert abs(kahan - f64) <= abs(plain - f64)

    def test_order3_ver4_compensated_not_worse(self):
        """On a real parquet graph, compensated f32 error <= plain f32 error
        (per root, against f64), and modes stay equivalent."""
        import jax.numpy as jnp
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.backends.compile import leafmap_of

        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [row["diagram"] for row in vertex4(para)]
        optimize_inplace(roots, level=1)
        leafmap = leafmap_of(roots)
        lowered = lower(roots, leafmap, sum_mode="fused")
        rng = np.random.default_rng(2)
        vals = rng.uniform(0.25, 4.0, (len(leafmap), 16))
        f64 = np.asarray(make_evaluator(lowered, dtype=jnp.float64)(vals))
        v32 = vals.astype(np.float32)
        plain = np.asarray(make_evaluator(lowered, dtype=jnp.float32)(v32))
        kahan = np.asarray(make_evaluator(lowered, dtype=jnp.float32,
                                          compensated=True)(v32))
        scale = np.abs(f64).max()
        err_plain = np.abs(plain - f64).max() / scale
        err_kahan = np.abs(kahan - f64).max() / scale
        assert err_kahan <= err_plain * 1.05
        assert err_kahan < 5e-6, err_kahan


class TestSchedule:
    def test_alap_equals_asap_and_shrinks_peak(self):
        """ALAP scheduling preserves values exactly and, on this non-cse
        config, does not enlarge the peak live set.  (With cse=True the
        bucket-grouping interaction can tip it the other way — measured
        1122 vs 1086 slots on this graph — so the assertion is
        deliberately scoped to cse=False.)"""
        import numpy as np
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.ops.lowering import lower
        from feynmandiagram.ops.evaluator import make_evaluator

        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        la = lower(roots, sum_mode="fused", schedule="asap")
        lb = lower(roots, sum_mode="fused", schedule="alap")
        assert lb.num_slots <= la.num_slots
        assert lb.num_edges == la.num_edges
        rng = np.random.default_rng(7)
        leaf = rng.uniform(0.5, 2.0, (la.num_leaves - len(la.const_slots), 4))
        oa = np.asarray(make_evaluator(la, dtype=np.float64)(leaf))
        ob = np.asarray(make_evaluator(lb, dtype=np.float64)(leaf))
        np.testing.assert_allclose(oa, ob, rtol=1e-12)

    def test_auto_picks_min(self):
        """schedule='auto' (round-5 default) must land on the smaller of the
        ASAP/ALAP peak slot counts — including with cse=True, the config
        where ALAP can lose — and produce identical outputs."""
        import numpy as np
        from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
        from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                          Ver4Diag, vertex4)
        from feynmandiagram.computational_graph import optimize_inplace
        from feynmandiagram.ops.lowering import lower
        from feynmandiagram.ops.evaluator import make_evaluator

        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        for cse in (False, True):
            la = lower(roots, sum_mode="fused", cse=cse, schedule="asap")
            lb = lower(roots, sum_mode="fused", cse=cse, schedule="alap")
            lc = lower(roots, sum_mode="fused", cse=cse, schedule="auto")
            assert lc.num_slots == min(la.num_slots, lb.num_slots), \
                (cse, la.num_slots, lb.num_slots, lc.num_slots)
            rng = np.random.default_rng(7)
            leaf = rng.uniform(0.5, 2.0,
                               (lc.num_leaves - len(lc.const_slots), 4))
            oa = np.asarray(make_evaluator(la, dtype=np.float64)(leaf))
            oc = np.asarray(make_evaluator(lc, dtype=np.float64)(leaf))
            np.testing.assert_allclose(oc, oa, rtol=1e-12)
