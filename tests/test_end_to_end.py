"""End-to-end slice (BASELINE config 1): two-loop self-energy via Parquet ->
optimize -> lower -> fused batched device evaluation of MC samples, validated
against an independent numpy evaluation of the same graphs.

Physics: free-fermion G(tau, eps, beta) with eps = k^2 - kF^2 and Yukawa
V(q) = 8 pi / (q^2 + lam), the conventions of the reference MC examples.
"""
import numpy as np
import pytest

from feynmandiagram.computational_graph import eval_graph, optimize_inplace
from feynmandiagram.frontends import (BareGreenId, BareInteractionId,
                                          ChargeCharge, Instant, NoHartree)
from feynmandiagram.frontends.parquet import (DiagPara, Interaction, SigmaDiag,
                                                  Ver4Diag, sigma, vertex4, mergeby)
from feynmandiagram.backends.compile import (compile_evaluator, leafmap_of,
                                                 export_artifact, load_artifact)
from feynmandiagram.models.reference import np_green, np_leaf_values

KF, BETA, LAM = 1.919, 0.5, 1.0


def _run_pipeline(roots, max_loop_num, batch=64, seed=7):
    rng = np.random.default_rng(seed)
    dim = 3
    varK = rng.standard_normal((dim, max_loop_num, batch))
    varT = rng.random((max_loop_num, batch)) * BETA

    compiled = compile_evaluator(roots, max_loop_num=max_loop_num, beta=BETA,
                                 kF=KF, lam=LAM)
    got = np.asarray(compiled(varK, varT))

    # independent host evaluation
    leafmap = leafmap_of(roots)
    leaf_vals = np_leaf_values(roots, leafmap, varK, varT,
                               beta=BETA, kF=KF, lam=LAM)
    for b in range(0, batch, batch // 4):
        expected = [eval_graph(r, leafmap, list(leaf_vals[:, b])) for r in roots]
        np.testing.assert_allclose(got[:, b], expected, rtol=1e-9, atol=1e-12)
    return got


class TestEndToEnd:
    def test_two_loop_sigma(self):
        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots)
        _run_pipeline(roots, para.totalLoopNum)

    def test_order3_vertex4(self):
        para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        df = vertex4(para)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots)
        _run_pipeline(roots, para.totalLoopNum, batch=32)

    def test_renormalized_series_one_shared_ir(self):
        """BASELINE config 4: self-energy with Taylor-mode AD to 2nd-order
        counterterms, ALL coefficient graphs lowered into ONE shared flat
        IR (SURVEY §7.1: coefficient sharing must survive lowering) and
        evaluated through the fused device pipeline; each counterterm root
        agrees with independent host evaluation."""
        from feynmandiagram.utility import taylorAD
        from feynmandiagram.frontends.diagram_id import (BareGreenId,
                                                             BareInteractionId)
        from feynmandiagram.ops.lowering import lower

        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots, level=1)
        dict_g = taylorAD(roots, [2, 2],
                          [lambda p: isinstance(p, BareGreenId),
                           lambda p: isinstance(p, BareInteractionId)])
        orders = sorted(dict_g)
        all_roots = [g for o in orders for g in dict_g[o]]
        optimize_inplace(all_roots, level=1)

        # one shared IR for the whole renormalized series
        compiled = compile_evaluator(all_roots, max_loop_num=para.totalLoopNum,
                                     beta=BETA, kF=KF, lam=LAM)
        rng = np.random.default_rng(3)
        batch = 8
        varK = rng.standard_normal((3, para.totalLoopNum, batch))
        varT = rng.random((para.totalLoopNum, batch)) * BETA
        got = np.asarray(compiled(varK, varT))
        assert got.shape[0] == len(all_roots)

        # independent host evaluation (counterterm leaves carry derivative
        # orders; np_leaf_values handles order-0 only, so evaluate with the
        # leaf kernels' own values instead)
        leafmap = leafmap_of(all_roots)
        from feynmandiagram.ops.leaf_eval import (leaf_tables_from_lowered,
                                                      make_leaf_evaluator)
        lv = np.asarray(compiled.leaf_fn(varK, varT))
        for b in range(0, batch, 4):
            expected = [eval_graph(r, leafmap, list(lv[:, b]))
                        for r in all_roots]
            np.testing.assert_allclose(got[:, b], expected, rtol=2e-7,
                                       atol=1e-10)

        # sharing survives: one shared IR is much smaller than per-order
        # lowerings summed
        shared = lower(all_roots, leafmap, sum_mode="fused", cse=True)
        per_order = 0
        for o in orders:
            per_order += lower(dict_g[o], sum_mode="fused", cse=True).num_slots
        assert shared.num_slots < 0.8 * per_order, (shared.num_slots, per_order)

    def test_renormalized_series_order4_named_scale(self):
        """BASELINE config 4 at its NAMED scale: order-4
        self-energy (innerLoopNum=4, NoHartree) with Taylor-mode AD to
        2nd-order counterterms in BOTH variables ([2,2] towers, 9 order
        tuples), every coefficient graph lowered through ONE shared flat IR
        and evaluated by the fused device pipeline; every counterterm root
        asserted against independent host evaluation.  Reference anchors:
        /root/reference/src/utility.jl:48-93 (taylorAD),
        /root/reference/test/taylor.jl:97-113 (the order-(2,v,g)
        equivalence contract this repo passes at orders 2-3)."""
        from feynmandiagram.utility import taylorAD
        from feynmandiagram.frontends.diagram_id import (BareGreenId,
                                                             BareInteractionId)
        from feynmandiagram.ops.lowering import lower

        para = DiagPara(type=SigmaDiag, innerLoopNum=4, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        roots = [row["diagram"] for row in sigma(para, extK, False)]
        optimize_inplace(roots, level=1)
        dict_g = taylorAD(roots, [2, 2],
                          [lambda p: isinstance(p, BareGreenId),
                           lambda p: isinstance(p, BareInteractionId)])
        orders = sorted(dict_g)
        assert len(orders) == 9            # (g, v) in {0,1,2} x {0,1,2}
        all_roots = [g for o in orders for g in dict_g[o]]
        optimize_inplace(all_roots, level=1)

        compiled = compile_evaluator(all_roots, max_loop_num=para.totalLoopNum,
                                     beta=BETA, kF=KF, lam=LAM)
        rng = np.random.default_rng(11)
        batch = 8
        varK = rng.standard_normal((3, para.totalLoopNum, batch))
        varT = rng.random((para.totalLoopNum, batch)) * BETA
        got = np.asarray(compiled(varK, varT))
        assert got.shape[0] == len(all_roots)

        leafmap = leafmap_of(all_roots)
        lv = np.asarray(compiled.leaf_fn(varK, varT))
        for b in (0, batch - 1):
            expected = [eval_graph(r, leafmap, list(lv[:, b]))
                        for r in all_roots]
            np.testing.assert_allclose(got[:, b], expected, rtol=2e-7,
                                       atol=1e-10)

        # coefficient sharing survives the shared lowering
        shared = lower(all_roots, leafmap, sum_mode="fused", cse=True)
        per_order = sum(lower(dict_g[o], sum_mode="fused", cse=True).num_slots
                        for o in orders)
        assert shared.num_slots < 0.8 * per_order, (shared.num_slots, per_order)

    @pytest.mark.parametrize("diag_type,order,pinned", [
        ("green", 1, 1.0), ("green", 2, -1.0), ("green", 3, -3.0),
        ("freeEnergy", 1, -1.0), ("freeEnergy", 2, 0.5),
        ("freeEnergy", 3, 3.0),
    ])
    def test_gv_green_free_energy_lower_eval(self, diag_type, order, pinned):
        """The Green and FreeEnergy GV readers
        (/root/reference/src/frontend/GV.jl:52-93 supports both types)
        driven through lower -> batched device eval with all leaves = 1;
        the root sum matches the pinned reference-table value (computed
        from the parsed SymFactor/SpinFactor content, cross-checked against
        host eval_graph)."""
        import os
        import pytest as _pytest
        from feynmandiagram.frontends import gv
        from feynmandiagram.ops.lowering import lower
        from feynmandiagram.ops.evaluator import make_evaluator

        if not os.environ.get("FD_GV_TABLES"):
            _pytest.skip("GV tables unavailable")
        roots = list(gv.diagsGV(diag_type, order))
        host = sum(eval_graph(r, {}, None) for r in roots)
        np.testing.assert_allclose(host, pinned, rtol=1e-10)

        optimize_inplace(roots, level=1)
        lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
        nl = lowered.num_leaves - len(lowered.const_slots)
        ev = make_evaluator(lowered, dtype=np.float64)
        got = np.asarray(ev(np.ones((nl, 4))))
        np.testing.assert_allclose(got.sum(axis=0), pinned, rtol=1e-10)

    def test_gv_polar_tables_through_pipeline(self):
        """GV-table-read graphs (not parquet-built) drive the identical
        compile -> leaf-kernel -> fused-eval pipeline; independent host
        evaluation agrees (the GV reader emits the same BareGreenId /
        BareInteractionId leaf vocabulary, frontends.jl:115-232)."""
        import os
        import pytest as _pytest
        from feynmandiagram.frontends import gv

        if not os.environ.get("FD_GV_TABLES"):
            _pytest.skip("GV tables unavailable")
        graphs = gv.diagsGV("chargePolar", 3)
        roots = list(graphs)
        optimize_inplace(roots, level=1)
        # chargePolar order 3: 3 inner loops + 1 external momentum
        _run_pipeline(roots, 4, batch=16)

    def test_artifact_roundtrip(self, tmp_path):
        from feynmandiagram.ops.evaluator import make_evaluator
        from feynmandiagram.ops.leaf_eval import make_leaf_evaluator

        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        df = sigma(para, extK, False)
        roots = [row["diagram"] for row in df]
        optimize_inplace(roots)

        path = str(tmp_path / "sigma2.npz")
        export_artifact(path, roots, max_loop_num=para.totalLoopNum)
        lowered, tables = load_artifact(path)

        rng = np.random.default_rng(3)
        varK = rng.standard_normal((3, para.totalLoopNum, 8))
        varT = rng.random((para.totalLoopNum, 8)) * BETA
        leaf_fn = make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM)
        graph_fn = make_evaluator(lowered)
        got = np.asarray(graph_fn(leaf_fn(varK, varT)))

        compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                     beta=BETA, kF=KF, lam=LAM)
        expected = np.asarray(compiled(varK, varT))
        np.testing.assert_allclose(got, expected, rtol=1e-12)


class TestModels:
    def test_green_kernel_matches_numpy(self):
        from feynmandiagram.models import green_kernel
        rng = np.random.default_rng(0)
        tau = rng.uniform(-BETA + 1e-3, BETA - 1e-3, 100)
        eps = rng.uniform(-30, 30, 100)
        got = np.asarray(green_kernel(tau, eps, BETA))
        np.testing.assert_allclose(got, np_green(tau, eps, BETA), rtol=1e-12)

    def test_green_derivative_tower_fd(self):
        from feynmandiagram.models import green_derive_tower
        tau, eps = 0.3, 0.7
        h = 1e-5
        # order-1 coefficient = -dG/deps
        fd = -(np_green(np.asarray(tau), eps + h, BETA)
               - np_green(np.asarray(tau), eps - h, BETA)) / (2 * h)
        got = float(green_derive_tower(tau, eps, BETA, 1))
        assert got == pytest.approx(float(fd), rel=1e-6)

    def test_green_derivative_tower_no_nan(self):
        from feynmandiagram.models import green_derive_tower
        tau = np.array([0.0, 0.49, -0.49, 0.001])
        eps = np.array([200.0, -200.0, 150.0, 0.0])
        for order in range(6):
            vals = np.asarray(green_derive_tower(tau, eps, BETA, order))
            assert np.all(np.isfinite(vals)), order


class TestArtifactV2:
    """Artifact round-trips for every lowering mode, and evaluation in a
    fresh process from the artifact alone (the 'generate in one job,
    evaluate in another' contract, SURVEY §5.4)."""

    def _roots(self):
        para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        roots = [row["diagram"] for row in sigma(para, extK, False)]
        optimize_inplace(roots)
        return roots, para

    def test_artifact_to_sharded_serving(self, tmp_path):
        """The config-5 serving workflow: generate + lower ONCE, export the
        artifact; a serving job loads it (no symbolic graphs, no parquet)
        and builds the graph-sharded MC step directly on its mesh."""
        import jax
        from feynmandiagram.ops.evaluator import make_evaluator
        from feynmandiagram.ops.leaf_eval import make_leaf_evaluator
        from feynmandiagram.parallel import (make_sample_mesh,
                                                 make_graph_sharded_evaluator)

        roots, para = self._roots()
        path = str(tmp_path / "sigma2_serve.npz")
        export_artifact(path, roots, max_loop_num=para.totalLoopNum,
                        sum_mode="fused", cse=True, reuse_slots=False)
        lowered, tables = load_artifact(path)

        rng = np.random.default_rng(5)
        nl = lowered.num_leaves - len(lowered.const_slots)
        vals = rng.uniform(0.5, 1.5, (nl, 8))
        single = np.asarray(make_evaluator(lowered)(vals))
        mesh = make_sample_mesh(4, axis_name="graph")
        sharded = make_graph_sharded_evaluator(lowered, mesh)
        np.testing.assert_allclose(np.asarray(sharded(vals)), single,
                                   rtol=1e-10, atol=1e-12)
        assert sharded.stats.local_slots < sharded.stats.full_slots

        # and the full MC step from the artifact's tables alone
        from feynmandiagram.parallel import make_graph_sharded_mc_step
        from jax.sharding import Mesh
        devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
        mesh2d = Mesh(devices, ("graph", "batch"))
        step = make_graph_sharded_mc_step(lowered, tables, mesh2d, beta=BETA,
                                          kF=KF, lam=LAM)
        means = np.asarray(step(jax.random.PRNGKey(1), 4, 2))
        assert np.all(np.isfinite(means))

    @pytest.mark.parametrize("sum_mode", ["csr", "bucketed", "fused"])
    def test_roundtrip_all_modes(self, tmp_path, sum_mode):
        from feynmandiagram.ops.evaluator import make_evaluator
        from feynmandiagram.ops.leaf_eval import make_leaf_evaluator
        from feynmandiagram.backends.compile import ARTIFACT_VERSION

        roots, para = self._roots()
        path = str(tmp_path / f"sigma2_{sum_mode}.npz")
        export_artifact(path, roots, max_loop_num=para.totalLoopNum,
                        sum_mode=sum_mode)
        z = np.load(path)
        assert int(z["version"]) == ARTIFACT_VERSION
        lowered, tables = load_artifact(path)
        assert lowered.leaf_uid_to_slot  # v2: leaf identity survives

        rng = np.random.default_rng(3)
        varK = rng.standard_normal((3, para.totalLoopNum, 8))
        varT = rng.random((para.totalLoopNum, 8)) * BETA
        leaf_fn = make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM)
        graph_fn = make_evaluator(lowered)
        got = np.asarray(graph_fn(leaf_fn(varK, varT)))

        compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                     beta=BETA, kF=KF, lam=LAM,
                                     sum_mode=sum_mode)
        expected = np.asarray(compiled(varK, varT))
        np.testing.assert_allclose(got, expected, rtol=1e-12)

    def test_second_process_evaluates_from_artifact_alone(self, tmp_path):
        """A fresh interpreter with no symbolic graphs reproduces the value."""
        import os
        import subprocess
        import sys

        roots, para = self._roots()
        path = str(tmp_path / "sigma2_fused.npz")
        export_artifact(path, roots, max_loop_num=para.totalLoopNum)

        rng = np.random.default_rng(3)
        varK = rng.standard_normal((3, para.totalLoopNum, 8))
        varT = rng.random((para.totalLoopNum, 8)) * BETA
        compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                     beta=BETA, kF=KF, lam=LAM)
        expected = np.asarray(compiled(varK, varT))
        np.save(tmp_path / "varK.npy", varK)
        np.save(tmp_path / "varT.npy", varT)

        script = f"""
import numpy as np
from feynmandiagram.backends.compile import load_artifact
from feynmandiagram.ops.evaluator import make_evaluator
from feynmandiagram.ops.leaf_eval import make_leaf_evaluator
lowered, tables = load_artifact({path!r})
leaf_fn = make_leaf_evaluator(tables, beta={BETA}, kF={KF}, lam={LAM})
graph_fn = make_evaluator(lowered)
varK = np.load({str(tmp_path / 'varK.npy')!r})
varT = np.load({str(tmp_path / 'varT.npy')!r})
np.save({str(tmp_path / 'out.npy')!r}, np.asarray(graph_fn(leaf_fn(varK, varT))))
"""
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_ENABLE_X64="1",
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
        subprocess.run([sys.executable, "-c", script], check=True, env=env,
                       timeout=300)
        got = np.load(tmp_path / "out.npy")
        np.testing.assert_allclose(got, expected, rtol=1e-12)
