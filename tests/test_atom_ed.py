"""Exact-diagonalization Atom oracle (models/atom_ed.py).

Reference counterpart: the Atom package of the strong-coupling-expansion
example (/root/reference/example/strong_coupling_expansion/Atom/src/ —
hilbert.jl Fock space, green.jl Model/GreenN, hubbard.jl builders), the
asset SURVEY Appendix E recommends reviving.  The ED machinery is checked
against INDEPENDENT formulas: the free-fermion kernel at U=0, the
closed-form Hubbard-atom self-energy (docs/src/manual/hubbard_atom.md via
models.hubbard_atom.exact_sigma), Wick's theorem at U=0, and operator
algebra identities.
"""
import math

import numpy as np
import pytest

from feynmandiagram.models.atom_ed import (
    DOWN, UP, EDModel, FockSpace, hubbard_atom_model, hubbard_dimer_model,
    hubbard_hamiltonian)


class TestFockSpace:
    def test_anticommutators(self):
        """{c_a, c†_b} = δ_ab, {c_a, c_b} = 0 with JW signs (2 sites)."""
        fock = FockSpace(2)
        modes = [(s, sp) for sp in (UP, DOWN) for s in (0, 1)]
        cs = {m: fock.creation(*m) for m in modes}
        for ma in modes:
            for mb in modes:
                anti = cs[ma].T @ cs[mb] + cs[mb] @ cs[ma].T
                expect = np.eye(fock.dim) if ma == mb else 0 * anti
                np.testing.assert_allclose(anti, expect, atol=1e-14)
                anti2 = cs[ma] @ cs[mb] + cs[mb] @ cs[ma]
                np.testing.assert_allclose(anti2, 0 * anti2, atol=1e-14)

    def test_atom_spectrum(self):
        """Hubbard-atom energies are {0, -mu, -mu, U-2mu} (hubbard.jl:36)."""
        fock = FockSpace(1)
        u, mu = 3.0, 0.7
        h = hubbard_hamiltonian(fock, 0.0, u, mu, [])
        e = np.sort(np.linalg.eigvalsh(h))
        np.testing.assert_allclose(
            e, np.sort([0.0, -mu, -mu, u - 2 * mu]), atol=1e-12)


class TestGreen:
    def test_free_atom_matches_kernel(self):
        """U=0 atom: g(τ) equals the free kernel e^{-ετ}/(1+e^{-εβ}) with
        ε=-mu (the pipeline's green convention, hubbard.jl:42-52), incl.
        the antiperiodic τ<0 branch."""
        beta, mu = 2.0, 0.4
        m = hubbard_atom_model(0.0, mu, beta)
        taus = np.asarray([-1.7, -0.3, 0.11, 0.9, 1.93])
        got = np.asarray(m.g_tau(taus))
        eps = -mu
        ref = []
        for t in taus:
            tp = t if t >= 0 else t + beta
            val = math.exp(-eps * tp) / (1 + math.exp(-eps * beta))
            ref.append(val if t >= 0 else -val)
        np.testing.assert_allclose(got, ref, rtol=1e-12)

    def test_density(self):
        """<n> from thermal_avg matches the grand-canonical formula."""
        beta, u, mu = 1.3, 2.0, 0.5
        m = hubbard_atom_model(u, mu, beta)
        fock = FockSpace(1)
        e_all = [0.0, -mu, -mu, u - 2 * mu]
        z = sum(math.exp(-beta * e) for e in e_all)
        n_exact = (math.exp(beta * mu) + math.exp(-beta * (u - 2 * mu))) / z
        cp = m.c_plus[0]
        n_op = cp @ cp.T
        np.testing.assert_allclose(m.thermal_avg(n_op), n_exact, rtol=1e-12)

    def test_ed_sigma_matches_closed_form(self):
        """The headline oracle: the ED Dyson self-energy
        Σ_std(iω_n) = iω_n + μ − 1/G_std(iω_n) must reproduce the
        closed-form exact_sigma for several (U, μ, β) and the first
        Matsubara frequencies.  G_std comes from the ED spectral sum +
        quadrature transform; exact_sigma from the independent
        reference-doc formula (hubbard_atom.md:55-58), which uses the
        reference's diagrammatic convention with a (−1) per interaction
        line (feynman_rule.md:88-110) — its Σ is the NEGATIVE of the
        standard Dyson Σ, verified here to 1e-13 at every parameter set."""
        from feynmandiagram.models.hubbard_atom import exact_sigma

        for (u, mu, beta) in [(1.0, 0.0, 1.0), (2.5, 0.6, 0.8),
                              (4.0, -0.3, 1.5)]:
            m = hubbard_atom_model(u, mu, beta)
            ghat = m.g_matsubara(4)
            for n in range(4):
                wn = (2 * n + 1) * math.pi / beta
                g_std = -ghat[n]          # standard G = -<Tτ c c†> transform
                sig = 1j * wn + mu - 1.0 / g_std
                ref = exact_sigma(wn, u, beta, mu)
                np.testing.assert_allclose(sig, -ref, rtol=1e-8, atol=1e-10)

    def test_gn_reduces_to_g(self):
        """The 2-point case of the N-body machinery equals g_tau."""
        m = hubbard_atom_model(1.7, 0.2, 1.1)
        for tau in (0.3, 0.9):
            full = m.gn_tau([tau, 0.0], [0, 0], [False, True])
            np.testing.assert_allclose(
                full, float(np.asarray(m.g_tau(np.asarray([tau])))[0]),
                rtol=1e-12)

    def test_wick_at_u0(self):
        """U=0: the connected 4-point vanishes and the full one equals the
        Wick determinant — for same-spin AND mixed-spin legs, atom and
        dimer."""
        for model in (hubbard_atom_model(0.0, 0.3, 1.2),
                      hubbard_dimer_model(0.7, 0.0, 0.1, 0.9)):
            ts = (0.8, 0.35, 0.6, 0.1)
            for modes in ((0, 0, 0, 0), (0, 1, 1, 0)):
                gc = model.g2_connected(*ts, *modes)
                assert abs(gc) < 1e-10, (modes, gc)

    def test_connected_nonzero_at_u(self):
        """U>0 atom: the connected 4-point (the vertex) is nonzero —
        the quantity the SCE builder's Gnc feeds on (green.jl Gnc)."""
        m = hubbard_atom_model(3.0, 0.0, 1.0)
        gc = m.g2_connected(0.8, 0.35, 0.6, 0.1, 0, 1, 1, 0)
        assert abs(gc) > 1e-3, gc

    def test_hopping_expansion_first_order(self):
        """SCE anchor (examples/strong_coupling_expansion.py): the dimer's
        off-diagonal ED Green's function equals one hopping line joining
        two exact atomic propagators, G_01 = t·g_atom², with residual
        O(t³) — the identity a future SCE graph builder must reproduce."""
        u, mu, beta = 2.0, 0.3, 1.2
        atom = hubbard_atom_model(u, mu, beta)
        g_at = atom.g_matsubara(2)
        for t in (0.02, 0.04):
            dimer = hubbard_dimer_model(t, u, mu, beta)
            g01 = dimer.g_matsubara(2, 0, 1)
            for n in range(2):
                err = abs(g01[n] - t * g_at[n] ** 2)
                assert err < 0.05 * t ** 3, (t, n, err)

    def test_dimer_u0_matches_two_level(self):
        """U=0 dimer: site-diagonal g(τ) is the equal mix of the bonding/
        antibonding free kernels (ε = ∓t − μ)."""
        t, mu, beta = 0.9, 0.2, 1.4
        m = hubbard_dimer_model(t, 0.0, mu, beta)
        taus = np.asarray([0.2, 0.7, 1.1])
        got = np.asarray(m.g_tau(taus, 0, 0))
        ref = np.zeros_like(got)
        for eps in (-t - mu, t - mu):
            ref += 0.5 * np.exp(-eps * taus) / (1 + math.exp(-eps * beta))
        np.testing.assert_allclose(got, ref, rtol=1e-10)
