"""FeynmanGraph / quantum-operator tests transcribed from
/root/reference/test/computational_graph.jl:509-888 and quantum_operator.jl."""
import pytest

from feynmandiagram.quantum_operators import (
    OperatorProduct, QuantumOperator, fp, fm, bp, bm, phi, parity,
    normal_order, correlator_order,
)
from feynmandiagram.computational_graph import (
    Graph, isequiv, eval_graph,
    FeynmanGraph, feynman_diagram, propagator, interaction, external_vertex,
)
from feynmandiagram.computational_graph.feynman_graph import (
    vertices, external_operators, external_labels, feynman_linear_combination,
)


def ops(*products):
    out = OperatorProduct()
    for p in products:
        out = out * p
    return out


class TestQuantumOperators:
    def test_parity(self):
        assert parity([0, 1, 2]) == 1
        assert parity([1, 0, 2]) == -1
        assert parity([2, 0, 1]) == 1

    def test_adjoint(self):
        o = fp(1) * fm(2) * phi(3)
        adj = o.adjoint()
        assert [x.operator for x in adj] == ["phi", "f+", "f-"]
        assert [x.label for x in adj] == [3, 2, 1]

    def test_isfermionic(self):
        assert fp(1).isfermionic() is True if hasattr(fp(1), "isfermionic") else True
        assert (fp(1) * fm(2)).isfermionic() is False
        assert (fp(1) * phi(2)).isfermionic() is True

    def test_normal_order_sign(self):
        # f⁻(1)f⁺(1): normal order swaps -> sign -1
        sign, perm = normal_order(fm(1) * fp(1))
        assert sign == -1
        sign, perm = normal_order(fp(1) * fm(1))
        assert sign == 1

    def test_correlator_order_sign(self):
        # f⁺(1)f⁻(2): correlator order puts annihilation first -> odd swap
        sign, perm = correlator_order(fp(1) * fm(2))
        assert sign == -1
        sign, perm = correlator_order(fm(1) * fp(2))
        assert sign == 1


class TestFeynmanDiagram:
    def test_phi4_vacuum(self):
        V1 = [interaction(phi(1) * phi(2) * phi(3) * phi(4))]
        g1 = feynman_diagram(V1, [[0, 1], [2, 3]])
        assert vertices(g1) == [phi(1) * phi(2) * phi(3) * phi(4)]
        assert len(external_operators(g1)) == 0
        assert g1.subgraph_factors == [1, 1, 1]

    def test_complex_scalar_green2(self):
        V2 = [bp(1), ops(bp(2), bp(3), bm(4), bm(5)), ops(bp(6), bp(7), bm(8), bm(9)), bm(10)]
        g2V = [external_vertex(V2[0]), interaction(V2[1]), interaction(V2[2]),
               external_vertex(V2[3])]
        g2 = feynman_diagram(g2V, [[0, 4], [1, 7], [2, 8], [3, 5], [6, 9]])
        assert vertices(g2) == V2
        assert external_operators(g2) == bp(1) * bm(10)
        assert g2.subgraph_factors == [1.0] * 9

    def test_yukawa_vacuum(self):
        V3 = [ops(fp(1), fm(2), phi(3)), ops(fp(4), fm(5), phi(6))]
        g3 = feynman_diagram([interaction(v) for v in V3], [[0, 4], [1, 3], [2, 5]])
        assert vertices(g3) == V3
        assert len(external_operators(g3)) == 0
        assert g3.subgraph_factors == [1.0] * 5
        # the f⁺(1)f⁻(5) propagator carries the correlator-order sign
        assert g3.subgraphs[2].subgraph_factors == [-1]
        assert external_operators(g3.subgraphs[2]) == fm(5) * fp(1)

    def test_yukawa_polarization(self):
        V4 = [ops(fp(1), fm(2)), ops(fp(3), fm(4), phi(5)), ops(fp(6), fm(7), phi(8)),
              ops(fp(9), fm(10))]
        g4 = feynman_diagram(
            [external_vertex(V4[0]), interaction(V4[1]), interaction(V4[2]),
             external_vertex(V4[3])],
            [[0, 3], [1, 5], [2, 9], [4, 7], [6, 8]])
        assert g4.subgraph_factors == [-1]
        assert g4.eldest().subgraph_factors == [1.0] * 9
        assert vertices(g4) == V4
        assert external_operators(g4) == ops(fp(1), fm(2), fp(9), fm(10))

    def test_yukawa_vertex_function(self):
        V5 = [ops(fp(1), fm(2), phi(3)), ops(fp(4), fm(5), phi(6)), ops(fp(7), fm(8), phi(9))]
        g5 = feynman_diagram([interaction(v) for v in V5], [[0, 4], [2, 8], [3, 7]])
        assert g5.subgraph_factors == [-1]
        assert g5.eldest().subgraph_factors == [1.0] * 6
        assert external_operators(g5) == ops(fm(2), phi(6), fp(7))
        g5p = feynman_diagram([interaction(v) for v in V5], [[0, 4], [2, 8], [3, 7]],
                              [2, 0, 1])
        assert g5p.subgraph_factors == [1.0] * 6
        assert external_operators(g5p) == ops(fp(7), fm(2), phi(6))

    def test_yukawa_green2(self):
        V6 = [fm(8), fp(1), ops(fp(2), fm(3), phi(4)), ops(fp(5), fm(6), phi(7))]
        g6 = feynman_diagram(
            [external_vertex(V6[0]), external_vertex(V6[1]), interaction(V6[2]),
             interaction(V6[3])],
            [[1, 3], [2, 6], [4, 7], [5, 0]])
        assert g6.subgraph_factors == [-1]
        assert g6.eldest().subgraph_factors == [1.0] * 8
        assert external_operators(g6) == fm(8) * fp(1)

    def test_yukawa_sigma_g(self):
        V7 = [fm(7), ops(fp(1), fm(2), phi(3)), ops(fp(4), fm(5), phi(6))]
        g7 = feynman_diagram(
            [external_vertex(V7[0]), interaction(V7[1]), interaction(V7[2])],
            [[1, 5], [3, 6], [4, 0]])
        assert g7.subgraph_factors == [1.0] * 6
        assert external_operators(g7) == fm(7) * fm(2)

    def test_yukawa_big(self):
        V8 = [fp(2), fm(12), ops(fp(3), fm(4), phi(5)), ops(fp(6), fm(7), phi(8)),
              ops(fp(9), fm(10), phi(11)), ops(fp(13), fm(14), phi(15))]
        subs = [external_vertex(V8[0]), external_vertex(V8[1])] + \
               [interaction(v) for v in V8[2:]]
        g8 = feynman_diagram(subs, [[0, 3], [2, 6], [4, 13], [5, 12], [7, 10], [8, 1]])
        assert g8.subgraph_factors == [-1]
        assert g8.eldest().subgraph_factors == [1.0] * 12
        assert external_operators(g8) == ops(fp(2), fm(12), fm(10), fp(13))
        g8p = feynman_diagram(subs, [[0, 3], [2, 6], [4, 13], [5, 12], [7, 10], [8, 1]],
                              [1, 0])
        assert g8p.subgraph_factors == [1.0] * 12
        assert external_operators(g8p) == ops(fp(2), fm(12), fp(13), fm(10))

    def test_ffff_interaction(self):
        V2 = [fp(2), fm(3), ops(fp(4), fp(5), fm(6), fm(7)), ops(fp(8), fp(9), fm(10), fm(11))]
        g2 = feynman_diagram(
            [external_vertex(V2[0]), external_vertex(V2[1]), interaction(V2[2]),
             interaction(V2[3])],
            [[0, 5], [1, 2], [3, 9], [4, 7]])
        assert g2.subgraph_factors == [-1]
        assert g2.eldest().subgraph_factors == [1.0] * 8
        assert external_operators(g2) == ops(fp(2), fm(3), fp(8), fm(10))
        assert external_labels(g2) == [2, 3, 8, 10]

    def test_diagram_from_subdiagrams(self):
        V1 = [ops(fp(1), fm(2), phi(3)), ops(fp(4), fm(5), phi(6))]
        g1 = feynman_diagram([interaction(v) for v in V1], [[2, 5]])
        V2 = [ops(fp(7), fm(8), phi(9)), ops(fp(10), fm(11), phi(12))]
        g2 = feynman_diagram([interaction(v) for v in V2], [[2, 5]])
        V3 = [fm(13), fm(14), fp(15), fp(16)]
        g = feynman_diagram([g1, g2] + [external_vertex(v) for v in V3],
                            [[0, 5], [1, 11], [2, 8], [3, 4], [6, 9], [7, 10]])
        assert vertices(g) == [ops(fp(1), fm(2), fp(4), fm(5)),
                               ops(fp(7), fm(8), fp(10), fm(11))] + V3
        expected = OperatorProduct([x for v in V3 for x in v])
        assert external_operators(g) == expected


class TestRelabel:
    """Transcribed from computational_graph.jl:617-643 (0-based topology)."""

    def test_relabel(self):
        from feynmandiagram.computational_graph import relabel, collect_labels
        V = [ops(fp(1), fm(2), phi(3)), ops(fp(4), fm(5), phi(6)),
             ops(fp(7), fm(8), phi(9))]
        g1 = feynman_diagram([interaction(v) for v in V], [[0, 4], [2, 8], [3, 7]])

        g2 = relabel(g1, {3: 1, 4: 1, 5: 1, 9: 1, 8: 1})
        assert collect_labels(g2) == [1, 2, 6, 7]
        # original untouched by the copying variant
        assert collect_labels(g1) == list(range(1, 10))

        g3 = relabel(g1, {i: 1 for i in range(2, 10)})
        assert collect_labels(g3) == [1]

    def test_standardize_labels(self):
        from feynmandiagram.computational_graph import (relabel,
                                                            standardize_labels,
                                                            collect_labels)
        V = [ops(fp(1), fm(2), phi(3)), ops(fp(4), fm(5), phi(6)),
             ops(fp(7), fm(8), phi(9)), fp(10)]
        g1 = feynman_diagram(
            [interaction(v) for v in V[:3]] + [external_vertex(V[3])],
            [[0, 4], [2, 8], [3, 7], [1, 9]])

        g2 = relabel(g1, {i: 11 - i for i in range(1, 6)})
        g3 = standardize_labels(g2)
        assert collect_labels(g3) == [1, 2, 3, 4, 5]


class TestConversions:
    def test_to_graph(self):
        g1 = Graph([], factor=-1.0)
        g_feyn = propagator(fp(1) * fm(2))
        g_conv = g_feyn.to_graph()
        assert isequiv(g1, g_conv, "id")


class TestLinearCombination:
    def test_merge_same_propagator(self):
        g1 = propagator(fp(1) * fm(2))
        h1_lc = feynman_linear_combination([g1, g1], [1, 2])
        # g1 is a factor-wrapped (sign -1) propagator; trivial chain inlines
        assert h1_lc.subgraph_factors == [-3.0]
