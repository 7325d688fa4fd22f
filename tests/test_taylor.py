"""TaylorSeries + taylorAD tests transcribed from /root/reference/test/taylor.jl."""
import math

import numpy as np
import pytest

from feynmandiagram.computational_graph import (Graph, PROD, SUM, eval_graph,
                                                    optimize_inplace)
from feynmandiagram.frontends import (BareGreenId, BareInteractionId,
                                          ChargeCharge, GenericId)
from feynmandiagram.frontends.parquet import DiagPara, GreenDiag
from feynmandiagram.taylor import (TaylorSeries, set_variables, get_numvars,
                                       taylor_factorial, taylor_binomial)
from feynmandiagram.utility import (taylorexpansion, taylorexpansion_graphs,
                                        taylorexpansion_by_leaftype, taylorAD)


class TestTaylorSeries:
    def test_polynomial_algebra(self):
        a, b, c, d, e = set_variables("a b c d e", orders=[3, 3, 3, 3, 3])
        F1 = (a + b) * (a + b) * (a + b)
        assert F1.get_coeff([2, 1, 0, 0, 0]) == 3.0
        assert F1.get_coeff([1, 2, 0, 0, 0]) == 3.0
        assert F1.get_coeff([3, 0, 0, 0, 0]) == 1.0
        assert F1.get_coeff([0, 3, 0, 0, 0]) == 1.0
        F2 = (1 + a) * (3 + 2 * c)
        assert F2.get_coeff([0, 0, 0, 0, 0]) == 3.0
        assert F2.get_coeff([1, 0, 0, 0, 0]) == 3.0
        assert F2.get_coeff([0, 0, 1, 0, 0]) == 2.0
        assert F2.get_coeff([1, 0, 1, 0, 0]) == 2.0
        F3 = (a + b) ** 3
        for order in [(2, 1), (1, 2)]:
            assert F3.get_coeff(list(order) + [0, 0, 0]) == 3.0
        assert F3.get_coeff([3, 0, 0, 0, 0]) == 1.0

    def test_truncation(self):
        a, = set_variables("a", orders=[2])
        F = (a + 1) ** 4
        # orders above 2 are truncated away
        assert F.get_coeff([2]) == 6.0
        assert F.get_coeff([1]) == 4.0
        assert F.get_coeff([0]) == 1.0
        assert len(F.coeffs) == 3

    def test_factorials(self):
        assert taylor_factorial([2, 3]) == 12
        assert taylor_binomial([1, 0], [1, 1]) == 2


def _getdiagram(spin=2.0, D=3, Nk=4, Nt=2):
    """The hand-built 2-bubble diagram of taylor.jl:113-161."""
    paraG = DiagPara(type=GreenDiag, innerLoopNum=0, totalLoopNum=Nk,
                     hasTau=True, totalTauNum=Nt)

    gK = [[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0]]
    gT = [(1, 2), (2, 1)]
    g = [Graph([], properties=BareGreenId(k=gK[i], t=gT[i]), name="G")
         for i in range(2)]
    vdK = [[0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 1.0, 0.0]]
    vd = [Graph([], properties=BareInteractionId(ChargeCharge, k=vdK[i], t=(0, 0)),
                name="Vd") for i in range(2)]
    veK = [[1, 0, -1, -1], [0, 1, 0, -1]]
    ve = [Graph([], properties=BareInteractionId(ChargeCharge, k=veK[i], t=(0, 0)),
                name="Ve") for i in range(2)]

    Id = GenericId(paraG)
    ggn = Graph([g[0], g[1]], properties=Id, operator=PROD)
    vdd = Graph([vd[0], vd[1]], properties=Id, operator=PROD, factor=spin)
    vde = Graph([vd[0], ve[1]], properties=Id, operator=PROD, factor=-1.0)
    ved = Graph([ve[0], vd[1]], properties=Id, operator=PROD, factor=-1.0)
    vsum = Graph([vdd, vde, ved], properties=Id, operator=SUM)
    root = Graph([vsum, ggn], properties=Id, operator=PROD,
                 factor=1 / (2 * math.pi) ** D, name="root")
    return root


def _assign_leaves(g, taylormap):
    """Assign coefficient value 1/order! so every derivative equals 1
    (taylor.jl:162-177)."""
    leafmap, leafvec = {}, []
    for leaf in g.leaves():
        taylor = taylormap[leaf.id]
        for order, coeff in taylor.coeffs.items():
            leafmap[coeff.id] = len(leafvec)
            leafvec.append(1.0 / taylor_factorial(order))
    return leafmap, leafvec


class TestTaylorADParquetGraph:
    def test_analytic_coefficients(self):
        """taylor.jl:181-208: coefficients equal (-2+spin)*2^k/k! factors."""
        spin, D = 0.5, 3
        root = _getdiagram(spin, D)
        optimize_inplace([root])

        factor = 1 / (2 * math.pi) ** D
        set_variables("x y", orders=[2, 2])
        propagator_var = {BareGreenId: [True, False], BareInteractionId: [False, True]}
        (t,), taylormap = taylorexpansion_by_leaftype([root], propagator_var)

        leafmap, leafvec = _assign_leaves(root, taylormap)

        def coeff_val(o):
            return eval_graph(t.coeffs[tuple(o)], leafmap, leafvec)

        assert coeff_val([0, 0]) == pytest.approx((-2 + spin) * factor)
        assert coeff_val([0, 1]) == pytest.approx((-2 + spin) * 2 * factor / taylor_factorial([0, 1]))
        assert coeff_val([1, 0]) == pytest.approx((-2 + spin) * 2 * factor / taylor_factorial([1, 0]))
        assert coeff_val([1, 1]) == pytest.approx((-2 + spin) * 4 * factor / taylor_factorial([1, 1]))
        assert coeff_val([2, 0]) == pytest.approx((-2 + spin) * 4 * factor / taylor_factorial([2, 0]))
        assert coeff_val([0, 2]) == pytest.approx((-2 + spin) * 4 * factor / taylor_factorial([0, 2]))


class TestTaylorAD:
    def test_taylorAD_api(self):
        root = _getdiagram(2.0)
        dict_g = taylorAD([root], [2, 2],
                          [lambda pr: isinstance(pr, BareGreenId),
                           lambda pr: isinstance(pr, BareInteractionId)])
        assert (0, 0) in dict_g
        assert (2, 2) in dict_g
        # 3x3 grid of orders
        assert len(dict_g) == 9
        # zeroth-order graph evaluates identically to the original root
        assert eval_graph(dict_g[(0, 0)][0]) == pytest.approx(eval_graph(root))

    def test_counterterm_leaf_orders(self):
        """Leaf coefficient graphs carry orders=o and leaf properties."""
        root = _getdiagram(2.0)
        dict_g = taylorAD([root], [1, 0],
                          [lambda pr: isinstance(pr, BareGreenId),
                           lambda pr: False])
        g10 = dict_g[(1, 0)][0]
        leaf_orders = {tuple(leaf.orders) for leaf in g10.leaves()
                       if isinstance(leaf.properties, BareGreenId)}
        assert (1, 0) in leaf_orders


class TestBenchmarkAD:
    """Nested-forward AD (build_derivative_backAD, utility.jl:314-403) must
    agree with the Taylor-series construction: derivative(o) == o! * coeff(o).

    Each leaf i is modeled as f_i(x, y) = v_i * exp(x + y): every derivative
    of the leaf is v_i, and the Taylor coefficient at order o is v_i / o!."""

    def _eval(self, graph, base, mode, leaftaylor=None):
        # derivative-mode leaves carry zero orders; their order is recovered
        # from leaftaylor (series.coeffs[o].id -> o)
        order_of = {}
        if leaftaylor is not None:
            for series in leaftaylor.values():
                for o, coeff in series.coeffs.items():
                    order_of[coeff.id] = o
        leafmap, vals = {}, []
        for leaf in graph.leaves():
            if leaf.operator.kind == "unitary" or leaf.id in leafmap:
                continue
            o = order_of.get(leaf.id, tuple(leaf.orders))
            leafmap[leaf.id] = len(vals)
            v = base[leaf.properties]
            vals.append(v if mode == "deriv" else v / taylor_factorial(o))
        return eval_graph(graph, leafmap, vals)

    def test_matches_taylorexpansion(self):
        from feynmandiagram.utility import (build_derivative_backAD,
                                                taylorexpansion)

        set_variables("x y", orders=[2, 2])
        l1 = Graph([], properties=("leaf", 1))
        l2 = Graph([], properties=("leaf", 2))
        l3 = Graph([], properties=("leaf", 3))
        g = (l1 + 2.0 * l2) * l3 + l1 * l1 * 0.5
        base = {("leaf", 1): 1.3, ("leaf", 2): 0.7, ("leaf", 3): -0.4}

        var_dep = {l.id: [True, True] for l in (l1, l2, l3)}
        series, _ = taylorexpansion(g, var_dep)
        deriv, leaftaylor = build_derivative_backAD(g)

        assert set(deriv.coeffs) == set(series.coeffs)
        for o, dgraph in deriv.coeffs.items():
            want = taylor_factorial(o) * self._eval(series.coeffs[o], base, "coeff")
            got = self._eval(dgraph, base, "deriv", leaftaylor)
            assert got == pytest.approx(want, rel=1e-12), o

    def test_power_operator(self):
        from feynmandiagram.computational_graph import Power
        from feynmandiagram.utility import (build_derivative_backAD,
                                                taylorexpansion)

        set_variables("x", orders=[3])
        l1 = Graph([], properties=("leaf", 1))
        g = Graph([l1], operator=Power(3), subgraph_factors=[2.0])
        base = {("leaf", 1): 0.9}

        series, _ = taylorexpansion(g, {l1.id: [True]})
        deriv, leaftaylor = build_derivative_backAD(g)
        for o, dgraph in deriv.coeffs.items():
            want = taylor_factorial(o) * self._eval(series.coeffs[o], base, "coeff")
            assert self._eval(dgraph, base, "deriv", leaftaylor) == pytest.approx(want, rel=1e-12), o


class TestDisplayAndMetrics:
    def test_pretty_print_numeric(self):
        from feynmandiagram.taylor import pretty_print
        x, y = set_variables("x y", orders=[2, 2])
        F = (1 + x) * (3 + 2 * y)
        s = pretty_print(F, big_o=False)
        assert "x y" in s and "3" in s
        assert "𝒪" in str(F)

    def test_pretty_print_graph_coeffs(self):
        from feynmandiagram.taylor import pretty_print
        set_variables("x", orders=[1])
        l1 = Graph([], properties=("leaf", 1))
        series, _ = __import__("feynmandiagram.utility", fromlist=["taylorexpansion"]).taylorexpansion(
            l1, {l1.id: [True]})
        s = pretty_print(series, big_o=False)
        assert "g" in s and " x" in s

    def test_count_operation_series(self):
        from feynmandiagram.computational_graph import count_operation
        from feynmandiagram.utility import taylorexpansion
        set_variables("x", orders=[2])
        l1 = Graph([], properties=("leaf", 1))
        l2 = Graph([], properties=("leaf", 2))
        g = l1 * l2 + l1
        series, _ = taylorexpansion(g, {l1.id: [True], l2.id: [True]})
        adds, muls = count_operation(series)
        assert adds > 0 and muls > 0
        # list-of-series form
        adds2, muls2 = count_operation([series])
        assert [adds2, muls2] == [adds, muls]


class TestContextIsolation:
    """Globals hygiene (SURVEY §5.2): interleaved builds must not corrupt
    each other's variable registries or vertex4I tables."""

    def test_taylor_context_restores(self):
        from feynmandiagram.taylor import (get_numvars, get_orders,
                                               set_variables, taylor_context)
        set_variables("u v w", orders=[1, 2, 3])
        with taylor_context("x", orders=[5]) as (x,):
            assert get_numvars() == 1
            assert get_orders() == [5]
            assert (x * x).get_coeff([2]) == 1.0
        assert get_numvars() == 3
        assert get_orders() == [1, 2, 3]

    def test_taylorad_does_not_clobber_registry(self):
        from feynmandiagram.taylor import get_orders, set_variables
        from feynmandiagram.utility import taylorAD
        from feynmandiagram.computational_graph import Graph

        set_variables("a b", orders=[4, 4])
        leaf = Graph([], properties=("g", 1))
        taylorAD([leaf], [2], [lambda p: True])
        assert get_orders() == [4, 4]

    def test_vertex4I_cache_keyed_by_config(self):
        from feynmandiagram.frontends.parquet.vertex4 import (
            _ver4I_key, get_ver4I)
        from feynmandiagram.frontends import NoHartree, Proper

        assert _ver4I_key(None, 0.0) == _ver4I_key([NoHartree], 0.0)
        assert _ver4I_key([NoHartree], 0.0) != _ver4I_key([NoHartree, Proper], 0.0)
        assert _ver4I_key([NoHartree], 0.0) != _ver4I_key([NoHartree], 0.5)
        # unseeded config reads empty, never another config's tables
        assert get_ver4I(spin_polar_para=0.123) == {}
