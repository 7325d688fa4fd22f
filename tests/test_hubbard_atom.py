"""Hubbard-atom end-to-end oracle: parquet sigma -> lowered device evaluator ->
Matsubara phase -> MC tau-integration vs the closed-form self-energy.

Revives the legacy reference test (test/hubbard.jl:1-114) on this pipeline;
the analytic series is docs/src/manual/hubbard_atom.md:53-62.
"""
import math

import pytest

from feynmandiagram.models.hubbard_atom import (exact_sigma,
                                                    sigma_power_series,
                                                    sigma_mc)

BETA, U = 2.3, 1.0


class TestAnalytic:
    def test_closed_form_matches_series(self):
        w0 = math.pi / BETA
        for u in (1e-3, 1e-2, 0.1):
            exact = exact_sigma(w0, u, BETA)
            series = sum(c * u ** (o + 1)
                         for o, c in enumerate(sigma_power_series(BETA)))
            assert abs(exact - series) < 10 * u ** 6

    def test_bare_limit(self):
        # U -> 0: Sigma -> 0
        assert abs(exact_sigma(math.pi / BETA, 0.0, BETA)) == 0.0


class TestSigmaMC:
    def test_order1_exact(self):
        # no free tau variables: the estimate is deterministic, Sigma1 = -U/2
        mean, _ = sigma_mc(1, U, BETA, batch=64, chunks=2)
        assert mean.real == pytest.approx(-U / 2, rel=1e-12)
        assert mean.imag == pytest.approx(0.0, abs=1e-12)

    def test_order2_vs_series(self):
        expect = sigma_power_series(BETA)[1] * U ** 2
        mean, err = sigma_mc(2, U, BETA, batch=4096, chunks=8, seed=1)
        assert abs(mean.real - expect.real) < 5 * max(abs(err.real), 1e-4)
        assert abs(mean.imag - expect.imag) < 5 * max(abs(err.imag), 1e-4)

    def test_order3_vs_series(self):
        expect = sigma_power_series(BETA)[2] * U ** 3
        mean, err = sigma_mc(3, U, BETA, batch=4096, chunks=8, seed=2)
        assert abs(mean.real - expect.real) < 5 * max(abs(err.real), 3e-4)
        assert abs(mean.imag - expect.imag) < 5 * max(abs(err.imag), 3e-4)

    def test_order4_vs_series(self):
        """One order beyond round 3 (and beyond the legacy reference test's
        live coverage): the order-4 parquet sigma MC estimate reproduces
        the U^4 coefficient of the closed-form Hubbard-atom series."""
        expect = sigma_power_series(BETA)[3] * U ** 4
        mean, err = sigma_mc(4, U, BETA, batch=8192, chunks=12, seed=3)
        assert abs(mean.real - expect.real) < 5 * max(abs(err.real), 5e-4)
        assert abs(mean.imag - expect.imag) < 5 * max(abs(err.imag), 5e-4)
