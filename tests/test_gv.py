"""GV front-end tests: reader + the flagship counterterm-equivalence oracle.

The counterterm test (reference taylor.jl:97-113) is the contract the
rebuilt taylorAD must satisfy bit-for-bit: the AD-generated coefficient
graph at order (g, v) evaluates identically (leaf values == 1) to the
independently tabulated counterterm diagram file Sigma2_{v}_{g}.diag.

Tables are read from the reference data directory (data contract, not code);
the self-hosted generator lands in frontends.gv.generator.
"""
import os

import pytest

REF_TABLES = "/root/reference/src/frontend/GV_diagrams"
pytestmark = pytest.mark.skipif(not os.path.isdir(REF_TABLES),
                                reason="GV tables unavailable")

from feynmandiagram.frontends import gv
from feynmandiagram.frontends.gv import diagsGV, diagsGV_ver4
from feynmandiagram.computational_graph import eval_graph
from feynmandiagram.frontends.common import Alli, PHr, PHEr, PPr
from feynmandiagram.taylor import set_variables
from feynmandiagram.utility import taylorexpansion_feynman

gv.set_table_path(REF_TABLES)


class TestReader:
    def test_sigma_graph_path(self):
        graphs = diagsGV("sigma", 2)
        # dynamic group (1,2) and instant group (1,1)
        ext_ts = {g.properties.extT for g in graphs}
        assert ext_ts == {(1, 2), (1, 1)}

    def test_polar_graph_path(self):
        graphs = diagsGV("chargePolar", 2)
        assert len(graphs) == 1
        assert eval_graph(graphs[0]) != 0

    def test_vertex4I_tables(self):
        graphs = diagsGV_ver4(3, channels=[Alli])
        assert len(graphs) > 0
        # graphs alternate UpUp / UpDown per (extT, channel) group
        from feynmandiagram.frontends.common import UpUp, UpDown
        assert graphs[0].properties.response == UpUp
        assert graphs[1].properties.response == UpDown

    def test_vertex4_full_tables(self):
        graphs = diagsGV_ver4(1)
        assert len(graphs) > 0

    def test_sigma_feynman_path(self):
        graphs, label_prod, ext_ts = diagsGV("sigma", 2, 0, 0)
        assert len(graphs) == len(ext_ts) == 2
        # static group first
        assert ext_ts[0][0] == ext_ts[0][1]


class TestCountertermEquivalence:
    def test_sigma2_counterterms(self):
        """AD coefficient graphs == tabulated counterterm diagrams."""
        orders = [(2, 0, 0), (2, 0, 1), (2, 0, 2), (2, 1, 0), (2, 1, 1),
                  (2, 2, 0), (2, 1, 2), (2, 2, 2)]
        dict_g = {}
        for o in orders:
            dict_g[o] = diagsGV("sigma", *o)[0]

        diags = dict_g[(2, 0, 0)]
        set_variables("x y", orders=[2, 2])
        propagator_var = ([True, False], [False, True])  # fermi: x, bose: y
        tvec, taylormap = taylorexpansion_feynman(diags, propagator_var)

        for order, graphs in dict_g.items():
            key = (order[1], order[2])  # (GOrder, VerOrder)
            for i in range(2):
                expected = eval_graph(graphs[i])
                got = eval_graph(tvec[i].coeffs[key])
                assert got == pytest.approx(expected), (order, i)

    def test_sigma3_counterterms(self):
        """Same contract at base order 3 (taylor.jl:97-113).

        Order-3 counterterm files exercise deeper Taylor-product
        convolutions and per-variable order capping than the order-2 case
        the reference tests stop at.
        """
        orders = [(3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1), (3, 2, 0),
                  (3, 0, 2), (3, 2, 1)]
        dict_g = {}
        for o in orders:
            dict_g[o] = diagsGV("sigma", *o)[0]

        diags = dict_g[(3, 0, 0)]
        set_variables("x y", orders=[3, 3])
        propagator_var = ([True, False], [False, True])  # fermi: x, bose: y
        tvec, _ = taylorexpansion_feynman(diags, propagator_var)

        for order, graphs in dict_g.items():
            key = (order[1], order[2])  # (GOrder, VerOrder)
            for i in range(min(2, len(graphs))):
                expected = eval_graph(graphs[i])
                got = eval_graph(tvec[i].coeffs[key])
                assert got == pytest.approx(expected), (order, i)

    def test_sigma4_counterterms(self):
        """The taylor.jl:97-113 contract at base order 4 — the base order
        of BASELINE config 4 — with mixed [2,2] counterterm corners
        (round 5).  The reference test suite stops at order 2; orders 3
        and 4 here exercise progressively deeper truncated-product
        convolutions against independently tabulated diagram files."""
        orders = [(4, 0, 0), (4, 1, 0), (4, 0, 1), (4, 1, 1), (4, 2, 0),
                  (4, 0, 2)]
        dict_g = {}
        for o in orders:
            dict_g[o] = diagsGV("sigma", *o)[0]

        diags = dict_g[(4, 0, 0)]
        set_variables("x y", orders=[2, 2])
        propagator_var = ([True, False], [False, True])  # fermi: x, bose: y
        tvec, _ = taylorexpansion_feynman(diags, propagator_var)

        for order, graphs in dict_g.items():
            key = (order[1], order[2])  # (GOrder, VerOrder)
            for i in range(min(2, len(graphs))):
                expected = eval_graph(graphs[i])
                got = eval_graph(tvec[i].coeffs[key])
                assert got == pytest.approx(expected), (order, i)

    def test_polar3_counterterms(self):
        """The same contract on the POLARIZATION table family at base
        order 3 (a different observable than the sigma files the reference
        test covers — exercises the charge-polar reader path plus
        the Taylor product on bubble-chain topologies)."""
        orders = [(3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1), (3, 2, 0),
                  (3, 0, 2)]
        dict_g = {}
        for o in orders:
            dict_g[o] = diagsGV("chargePolar", *o)[0]

        diags = dict_g[(3, 0, 0)]
        set_variables("x y", orders=[3, 3])
        propagator_var = ([True, False], [False, True])
        tvec, _ = taylorexpansion_feynman(diags, propagator_var)

        for order, graphs in dict_g.items():
            key = (order[1], order[2])
            for i in range(min(2, len(graphs))):
                expected = eval_graph(graphs[i])
                got = eval_graph(tvec[i].coeffs[key])
                assert got == pytest.approx(expected), (order, i)
