"""Brute-force enumeration oracle (frontends/parquet/benchmark/brute_force):
independent of both the parquet recursion and the GV tables.

Verifies the published count formulas AND the live parquet pipeline in both
sign conventions — including polarization order 5, which neither the
reference nor any earlier round ever checked live.
"""
import numpy as np
import pytest

from feynmandiagram.computational_graph import eval_graph
from feynmandiagram.frontends import (NoHartree, NoFock, Girreducible,
                                          ChargeCharge, Instant)
from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  PolarDiag, polarization,
                                                  benchmark)
from feynmandiagram.frontends.parquet.benchmark.brute_force import (
    count_polar_brute_force, count_sigma_brute_force)


class TestBruteForceVsFormulas:
    @pytest.mark.parametrize("l", [2, 3, 4])
    def test_polar_counts(self, l):
        upup, updown = count_polar_brute_force(l, spin=2)
        assert 2 * upup == benchmark.count_polar_g2v_noFock_upup(l, 2)
        assert 2 * updown == benchmark.count_polar_g2v_noFock_updown(l, 2)

    @pytest.mark.parametrize("l", [2, 3])
    def test_sigma_counts(self, l):
        assert count_sigma_brute_force(l, 2) == benchmark.count_sigma_G2v(l, 2)


def _polar_rows(l, is_fermi):
    para = DiagPara(type=PolarDiag, innerLoopNum=l, isFermi=is_fermi,
                    hasTau=True, filter=(NoHartree, NoFock),
                    interaction=(Interaction(ChargeCharge, Instant),))
    Q = np.zeros(para.totalLoopNum)
    Q[0] = 1
    return {str(r["response"]): eval_graph(r["diagram"])
            for r in polarization(para, Q)}


class TestBruteForceVsLiveParquet:
    @pytest.mark.parametrize("l", [3, 4])
    def test_fermionic_matches(self, l):
        """Live parquet (isFermi=True, leaf==1) == signed brute force."""
        upup, updown = count_polar_brute_force(l, spin=2, fermionic=True)
        vals = _polar_rows(l, True)
        sign = (-1) ** (l - 1)
        assert vals["5"] * sign == pytest.approx(upup)
        assert vals["6"] * sign == pytest.approx(updown)

    def test_order5_fermionic_pinned(self):
        """Order-5 fermionic values, pinned from the brute-force enumerator
        (C++-accelerated run over all 10! permutations, round 3):
        S_upup=39, S_updown=22 over 1,085 topologies — includes the 64
        topologies with fully-irreducible (2PI) 4-point cores delivered by
        the Alli table insertion (without Alli the UpDown value is 20)."""
        vals = _polar_rows(5, True)
        assert vals["5"] == pytest.approx(39.0)
        assert vals["6"] == pytest.approx(22.0)

    def test_order5_bosonic_convention_caveat(self):
        """Documented caveat (see brute_force module docstring): with
        isFermi=False the count identity breaks at order 5 because the
        Vertex4I tables bake in fermionic factors; the live values are
        (3418, 764), NOT the published (3586, 844).  This test pins the
        behavior so any change (e.g. a convention-aware Alli insertion)
        is noticed."""
        vals = _polar_rows(5, False)
        assert vals["5"] * 2 == pytest.approx(3418.0)
        assert vals["6"] * 2 == pytest.approx(764.0)
