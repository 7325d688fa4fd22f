"""Front-end infrastructure tests (reference front_end.jl:7-183)."""
import numpy as np
import pytest

from feynmandiagram.frontends import (LoopPool, LabelProduct, BareGreenId,
                                          BareInteractionId, GenericId, SigmaId,
                                          mirror_symmetrize, reconstruct,
                                          ChargeCharge, UpUp, Instant, Dynamic,
                                          leafstates)
from feynmandiagram.frontends.parquet import (DiagPara, SigmaDiag, GreenDiag,
                                                  Ver4Diag, reconstruct_para,
                                                  inner_tau_num, first_tau_idx,
                                                  first_loop_idx, interaction_tau_num,
                                                  Interaction)
from feynmandiagram.computational_graph import Graph


class TestLoopPool:
    def test_dedup_and_update(self):
        """LoopPool dedup + update against dense matmul (front_end.jl:7-36)."""
        dim, N = 3, 4
        loop_pool = LoopPool("K", dim, N)
        basis1 = [1.0, 0.0, 0.0, 1.0]
        basis2 = [1.0, 1.0, 0.0, 0.0]
        basis3 = [1.0, 0.0, -1.0, 1.0]
        idx1 = loop_pool.append(basis1)
        idx2 = loop_pool.append(basis2)
        idx3 = loop_pool.append(basis2)
        idx4 = loop_pool.append(basis1)
        idx5 = loop_pool.append(basis3)
        assert len(loop_pool) == 3
        assert idx1 == idx4 == 0
        assert idx2 == idx3 == 1
        assert idx5 == 2

        var_k = np.random.rand(dim, N)
        loop_pool.update(var_k)
        for i, basis in enumerate([basis1, basis2, basis3]):
            np.testing.assert_allclose(loop_pool.loop(i), var_k @ np.asarray(basis),
                                       rtol=1e-12)


class TestLabelProduct:
    def test_index_bijections(self):
        """linear<->multi index maps are inverse bijections (front_end.jl:38-68)."""
        lp = LabelProduct([1, 2, 3], ["a", "b"], [0.1, 0.2, 0.3, 0.4])
        assert len(lp) == 3 * 2 * 4
        for linear in range(len(lp)):
            multi = lp.linear_to_index(linear)
            assert lp.index_to_linear(*multi) == linear
        # values at an index
        assert lp[0] == (1, "a", 0.1)
        assert lp[(2, 1, 3)] == (3, "b", 0.4)

    def test_push_labelat(self):
        lp = LabelProduct([1, 2], [(1.0, 0.0)])
        i = lp.push_labelat((0.0, 1.0), 1)
        assert i == 1
        assert lp.push_labelat((1.0, 0.0), 1) == 0
        assert lp.dims == (2, 2)


class TestDiagramId:
    def test_mirror_symmetrize(self):
        assert mirror_symmetrize([-1.0, 0.0, 1.0]) == (1.0, 0.0, -1.0)
        assert mirror_symmetrize([0.0, 1.0]) == (0.0, 1.0)
        assert mirror_symmetrize([0.0, 0.0]) == (0.0, 0.0)

    def test_green_id_equality(self):
        a = BareGreenId(k=[1.0, 0.0], t=(1, 2))
        b = BareGreenId(k=[-1.0, 0.0], t=(1, 2))  # mirror-symmetrized equal
        c = BareGreenId(k=[1.0, 0.0], t=(1, 3))
        assert a == b
        assert hash(a) == hash(b)
        assert a != c

    def test_interaction_id_tau_symmetry(self):
        """Instant ids with time-local extT are equal regardless of the index
        (diagram_id.jl:49-69)."""
        a = BareInteractionId(ChargeCharge, Instant, k=[1.0], t=(1, 1))
        b = BareInteractionId(ChargeCharge, Instant, k=[1.0], t=(2, 2))
        c = BareInteractionId(ChargeCharge, Instant, k=[1.0], t=(1, 2))
        d = BareInteractionId(ChargeCharge, Instant, k=[1.0], t=(1, 2))
        assert a == b
        assert hash(a) == hash(b)
        assert a != c
        assert c == d

    def test_reconstruct(self):
        a = BareGreenId(k=[1.0, 0.0], t=(1, 2))
        b = reconstruct(a, extT=(3, 4))
        assert b.extT == (3, 4)
        assert b.extK == a.extK
        s = SigmaId("para", Dynamic, k=[1.0], t=(1, 2))
        s2 = reconstruct(s, para="other")
        assert s2.para == "other"


class TestDiagPara:
    def test_derived_defaults(self):
        para = DiagPara(type=Ver4Diag, innerLoopNum=2)
        assert para.firstLoopIdx == first_loop_idx(Ver4Diag) == 4
        assert para.totalLoopNum == 5
        assert para.firstTauIdx == 1
        assert para.totalTauNum == 3  # (2+1)*1 instant
        assert para.interactionTauNum == 1

    def test_reconstruct_keeps_budget(self):
        para = DiagPara(type=SigmaDiag, innerLoopNum=3)
        sub = reconstruct_para(para, type=GreenDiag, innerLoopNum=1,
                               firstLoopIdx=3, firstTauIdx=2)
        assert sub.totalTauNum == para.totalTauNum
        assert sub.totalLoopNum == para.totalLoopNum
        assert sub.type == GreenDiag

    def test_inner_tau_num(self):
        assert inner_tau_num(Ver4Diag, 2, 1) == 3
        assert inner_tau_num(SigmaDiag, 2, 1) == 2
        assert inner_tau_num(GreenDiag, 2, 1) == 2

    def test_equality_and_hash(self):
        p1 = DiagPara(type=SigmaDiag, innerLoopNum=2)
        p2 = DiagPara(type=SigmaDiag, innerLoopNum=2)
        assert p1 == p2
        assert hash(p1) == hash(p2)


class TestLeafstates:
    def test_soa_tables(self):
        g1 = Graph([], properties=BareGreenId(k=[1.0, 0.0], t=(1, 2)))
        g2 = Graph([], properties=BareInteractionId(ChargeCharge, Instant,
                                                    k=[0.0, 1.0], t=(1, 1)))
        g3 = Graph([], properties=BareGreenId(k=[1.0, 0.0], t=(2, 1)))
        leafmap = {0: g1, 1: g2, 2: g3}
        (vals, types, orders, tin, tout, loopidx), basis = leafstates([leafmap], 3)
        assert types[0] == [1, 2, 1]
        assert tin[0] == [1, 1, 2]
        assert tout[0] == [2, 1, 1]
        # g1 and g3 share the same momentum basis entry
        assert loopidx[0][0] == loopidx[0][2]
        assert len(basis) == 2
