"""Parquet front-end tests: diagram-count oracles and filter semantics.

Transcribed from /root/reference/test/front_end.jl:185-219, 600-824.
Evaluation with all leaves == 1 must reproduce the closed-form diagram
counts of arXiv:cond-mat/0512342.
"""
import numpy as np
import pytest

from feynmandiagram.computational_graph import eval_graph
from feynmandiagram.frontends import (Filter, NoHartree, NoFock, Girreducible,
                                          Proper, ChargeCharge, Instant, UpUp)
from feynmandiagram.frontends.parquet import (
    DiagPara, Interaction, ParquetBlocks, SigmaDiag, GreenDiag, PolarDiag,
    Ver3Diag, Ver4Diag, ordered_partition, find_first_loop_idx,
    find_first_tau_idx, sigma, green, vertex3, polarization, mergeby,
    is_valid_g, is_valid_sigma, benchmark,
)
from feynmandiagram.ops import evaluate_graphs, lower, make_evaluator


class TestBookkeeping:
    def test_ordered_partition(self):
        parts = ordered_partition(5, 2)
        assert sorted(map(tuple, parts)) == [(1, 4), (2, 3), (3, 2), (4, 1)]
        parts0 = ordered_partition(3, 2, 0)
        assert sorted(map(tuple, parts0)) == [(0, 3), (1, 2), (2, 1), (3, 0)]

    def test_find_first_loop_idx(self):
        assert find_first_loop_idx([1, 1, 2, 1], 1) == ([1, 2, 3, 5], 5)
        assert find_first_loop_idx([1, 0, 2, 0], 1) == ([1, 2, 2, 4], 3)

    def test_find_first_tau_idx(self):
        types = [Ver4Diag, GreenDiag, Ver4Diag, GreenDiag]
        assert find_first_tau_idx([1, 1, 2, 1], types, 1, 1) == ([1, 3, 4, 7], 7)
        assert find_first_tau_idx([1, 0, 2, 0], types, 1, 1) == ([1, 3, 3, 6], 5)


class TestFilters:
    def test_is_valid_g(self):
        assert is_valid_g([NoFock, NoHartree], 1) is False
        assert is_valid_g([NoFock], 1) is True
        assert is_valid_g([Girreducible], 1) is False
        assert is_valid_g([Girreducible], 0) is True
        assert is_valid_g([], 2) is True

    def test_is_valid_sigma(self):
        assert is_valid_sigma([], 0, False) is False
        assert is_valid_sigma([Girreducible], 1, True) is False
        assert is_valid_sigma([Girreducible], 1, False) is True
        assert is_valid_sigma([NoFock, NoHartree], 1, True) is False
        assert is_valid_sigma([NoFock, NoHartree], 1, False) is True
        assert is_valid_sigma([], 2, True) is True


def _sigma_para(loop_num, spin=2, filter=(NoHartree, Girreducible)):
    return DiagPara(type=SigmaDiag, hasTau=True, innerLoopNum=loop_num,
                    totalLoopNum=loop_num + 1, totalTauNum=loop_num,
                    isFermi=False, spin=spin, firstLoopIdx=2, firstTauIdx=1,
                    filter=tuple(filter),
                    interaction=(Interaction(ChargeCharge, Instant),))


class TestSigmaCounts:
    @pytest.mark.parametrize("l", [1, 2, 3, 4])
    def test_sigma_G2v(self, l):
        if l >= 4:  # order-4 needs the fully-irreducible vertex tables
            from feynmandiagram.frontends.parquet.vertex4 import (
                initialize_vertex4I_diags, get_ver4I)
            if not get_ver4I():
                initialize_vertex4I_diags()
        para = _sigma_para(l)
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        merged = mergeby(df)
        w = eval_graph(merged[0]["diagram"])
        assert w * (-1) ** para.innerLoopNum == pytest.approx(
            benchmark.count_sigma_G2v(l, para.spin))

    @pytest.mark.parametrize("l", [1, 2, 3])
    def test_sigma_G2v_tpu_eval(self, l):
        """Same count via the lowered batched evaluator (leaf==1)."""
        para = _sigma_para(l)
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        merged = mergeby(df)
        root = merged[0]["diagram"]
        lowered = lower([root])
        f = make_evaluator(lowered)
        out = np.asarray(f(np.ones((lowered.num_leaves - len(lowered.const_slots), 1))))
        assert out[0, 0] * (-1) ** l == pytest.approx(
            benchmark.count_sigma_G2v(l, para.spin))


class TestGreenFilters:
    def _build_g(self, loop_num, ext_t, filter):
        para = DiagPara(type=GreenDiag, hasTau=True, innerLoopNum=loop_num,
                        isFermi=True, spin=2, filter=tuple(filter),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        if is_valid_g(para):
            return green(para, extK, ext_t)
        return None

    def test_girreducible(self):
        assert self._build_g(0, (1, 2), [NoHartree, Girreducible]) is not None
        assert self._build_g(1, (1, 2), [NoHartree, Girreducible]) is None
        assert self._build_g(2, (1, 2), [NoHartree, Girreducible]) is None

    def test_nofock(self):
        assert self._build_g(0, (1, 2), [NoHartree, NoFock]) is not None
        assert self._build_g(1, (1, 2), [NoHartree, NoFock]) is None
        assert self._build_g(2, (1, 2), [NoHartree, NoFock]) is not None


class TestVertex3Counts:
    @pytest.mark.parametrize("l", [1, 2, 3])
    def test_ver3_G2v(self, l):
        para = DiagPara(type=Ver3Diag, innerLoopNum=l, isFermi=False, hasTau=True,
                        filter=(NoHartree, Girreducible, Proper),
                        interaction=(Interaction(ChargeCharge, Instant),))
        K0 = np.zeros(para.totalLoopNum)
        KinL, Q = K0.copy(), K0.copy()
        Q[0] = 1
        KinL[1] = 1
        rows = vertex3(para, [Q, KinL])
        merged = mergeby(rows)
        w = eval_graph(merged[0]["diagram"])
        assert w * (-1) ** l == pytest.approx(benchmark.count_ver3_G2v(l, para.spin))


def _polar_rows(l, filter):
    para = DiagPara(type=PolarDiag, innerLoopNum=l, isFermi=False, hasTau=True,
                    filter=tuple(filter),
                    interaction=(Interaction(ChargeCharge, Instant),))
    Q = np.zeros(para.totalLoopNum)
    Q[0] = 1
    return para, polarization(para, Q)


class TestPolarizationCounts:
    def test_explicit_proper(self):
        _polar_rows(1, [Proper, NoHartree, NoFock])

    @pytest.mark.parametrize("l", [1, 2, 3, 4])
    def test_polar_G2v(self, l):
        para, rows = _polar_rows(l, [NoHartree, Girreducible])
        merged = mergeby(rows)
        w = eval_graph(merged[0]["diagram"])
        assert w * para.spin * (-1) ** (l - 1) == pytest.approx(
            benchmark.count_polar_G2v(l, para.spin))

    @pytest.mark.parametrize("l", [1, 2, 3, 4])
    def test_polar_g2v_noFock(self, l):
        para, rows = _polar_rows(l, [NoHartree, NoFock])
        merged = mergeby(rows)
        w = eval_graph(merged[0]["diagram"])
        assert w * para.spin * (-1) ** (l - 1) == pytest.approx(
            benchmark.count_polar_g2v_noFock(l, para.spin))

    @pytest.mark.parametrize("l", [1, 2, 3, 4])
    def test_polar_g2v_noFock_upup(self, l):
        para, rows = _polar_rows(l, [NoHartree, NoFock])
        w = eval_graph(rows[0]["diagram"])  # first row is UpUp
        assert rows[0]["response"] == UpUp
        assert w * para.spin * (-1) ** (l - 1) == pytest.approx(
            benchmark.count_polar_g2v_noFock_upup(l, para.spin))


class TestSigmaGVAndEpCoupling:
    def test_sigma_gv_runs(self):
        from feynmandiagram.frontends.parquet import sigmaGV
        para = DiagPara(type=SigmaDiag, innerLoopNum=1, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        rows = sigmaGV(para, extK, False)
        assert len(rows) >= 1
        for row in rows:
            assert np.isfinite(eval_graph(row["diagram"]))

    def test_ep_coupling_runs(self):
        import warnings
        from feynmandiagram.frontends.parquet import ep_coupling
        from feynmandiagram.frontends import Dynamic
        para = DiagPara(type=Ver4Diag, hasTau=True, innerLoopNum=2,
                        interaction=(Interaction(ChargeCharge, [Instant, Dynamic]),))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rows = ep_coupling(para)
        assert len(rows) >= 1
        for row in rows:
            assert np.isfinite(eval_graph(row["diagram"]))


class TestADCrossValidation:
    def test_taylor_first_order_equals_forward_ad_sum(self):
        """taylorAD's (1,) coefficient with coefficient-leaves == 1 equals the
        sum of forward-AD derivatives over all dependent leaves."""
        from feynmandiagram.frontends import BareGreenId
        from feynmandiagram.utility import taylorAD
        from feynmandiagram.computational_graph import forward_ad

        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        root = mergeby(df)[0]["diagram"]

        rng = np.random.default_rng(7)
        leafmap, vals = {}, []
        for leaf in root.leaves():
            if leaf.id not in leafmap:
                leafmap[leaf.id] = len(vals)
                vals.append(rng.uniform(0.5, 1.5))

        dict_g = taylorAD([root], [1],
                          [lambda p: isinstance(p, BareGreenId)])
        coeff = dict_g[(1,)][0]
        # coefficient graphs introduce fresh derivative leaves; assign them 1
        # (dG/dx == 1) and the base leaves their values
        cmap, cvals = dict(leafmap), list(vals)
        for leaf in coeff.leaves():
            if leaf.id not in cmap:
                cmap[leaf.id] = len(cvals)
                cvals.append(1.0)
        got = eval_graph(coeff, cmap, cvals)

        expected = 0.0
        for uid, idx in leafmap.items():
            leaf = next(l for l in root.leaves() if l.id == uid)
            if isinstance(leaf.properties, BareGreenId):
                d = forward_ad(root, uid)
                if isinstance(d, (int, float)):
                    expected += d
                else:
                    dmap, dvals = dict(leafmap), list(vals)
                    for l in d.leaves():
                        if l.id not in dmap:
                            dmap[l.id] = len(dvals)
                            dvals.append(l.weight if l.operator.kind == "unitary" else 0.0)
                    expected += eval_graph(d, dmap, dvals)
        assert got == pytest.approx(expected, rel=1e-9)


class TestSigmaGVCrossCheck:
    """sigmaGV vs sigma where they coincide: the reference's sigmaGV builds
    only the Fock-type (oW=0) instant rows (sigmaGV.jl:112-117 computes the
    composite-W vertex3 and discards it), so its rows must equal sigma's
    instant rows numerically under physical leaf evaluation."""

    @pytest.mark.parametrize("l", [1, 2])
    def test_instant_rows_agree(self, l):
        from feynmandiagram.frontends.parquet import sigmaGV
        from feynmandiagram.backends.compile import compile_evaluator
        from feynmandiagram.frontends import Instant as InstantProp

        para = DiagPara(type=SigmaDiag, innerLoopNum=l, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        rng = np.random.default_rng(0)
        varK = rng.standard_normal((3, para.totalLoopNum, 4))
        varT = rng.random((para.totalLoopNum, 4)) * 0.5

        def rows_by_extT(fn):
            rows = fn(para, extK, False)
            c = compile_evaluator([r["diagram"] for r in rows],
                                  max_loop_num=para.totalLoopNum,
                                  beta=0.5, kF=1.919, lam=1.0)
            out = np.asarray(c(varK, varT))
            return {tuple(r["extT"]): out[i] for i, r in enumerate(rows)}

        s = rows_by_extT(sigma)
        gv = rows_by_extT(sigmaGV)
        for t, v in gv.items():
            assert t in s
            np.testing.assert_allclose(v, s[t], rtol=1e-10)
        # instant (tau-local) rows coincide exactly; at l>1 sigma also has
        # dynamic rows that sigmaGV (by reference semantics) does not build
        assert all(t[0] == t[1] for t in gv)


class TestEpCouplingValues:
    def test_leaf1_pinned_counts(self):
        """Electron-phonon vertex leaf==1 sums.

        Order 1 = -8 is DERIVED in closed form (docs/oracles.md
        "Electron-phonon vertex order-1 value"): the bare-vertex spin sums
        (sum_L_uu = 0, sum_L_ud = -2; right Di-only sums = -2) composed
        through the PHr recoupling give 8, times SymFactor[PHr] = -1.
        Order 2 = 64 = (-8)^2 remains a pinned regression anchor (the
        reference ships no ep_coupling value tests at all)."""
        import warnings
        from feynmandiagram.frontends.parquet import ep_coupling
        from feynmandiagram.frontends import Dynamic
        expected = {1: -8.0, 2: 64.0}
        for l, want in expected.items():
            para = DiagPara(type=Ver4Diag, hasTau=True, innerLoopNum=l,
                            interaction=(Interaction(ChargeCharge,
                                                     [Instant, Dynamic]),))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rows = ep_coupling(para)
            total = sum(eval_graph(r["diagram"]) for r in rows)
            assert total == pytest.approx(want), (l, total)
