"""Cross-validation of parquet graphs against the independent oracle
evaluator (reference front_end.jl:446-598 "ParquetNew Ver4").

The oracle rebuilds the parquet recursion with explicit (direct, exchange)
weight tables and shares no code with the graph pipeline.  With physical
G/V the relations are:  UpUp = direct + exchange,  UpDown = direct.
(The reference left these assertions commented; they hold and are enforced
here.)
"""
import numpy as np
import pytest

from feynmandiagram.computational_graph import eval_graph, optimize
from feynmandiagram.frontends import (BareGreenId, BareInteractionId,
                                          ChargeCharge, Girreducible, Instant,
                                          NoHartree, PHEr, PHr, PPr, UpDown, UpUp)
from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  ParquetBlocks, Ver4Diag,
                                                  mergeby, vertex4)
from feynmandiagram.frontends.parquet.benchmark.vertex4_oracle import (
    I, S, T, U, Ver4, eval_ver4)

KF, BETA, MASS2 = 1.0, 1.0, 1.0


def eval_g(K, tin, tout):
    eps = np.dot(K, K) / 2 - KF ** 2
    tau = tout - tin
    if abs(tau) < 1e-12:
        tau = -1e-8
    # stable fermionic kernel
    if tau > 0:
        if eps > 0:
            return np.exp(-eps * tau) / (1 + np.exp(-eps * BETA))
        return np.exp(eps * (BETA - tau)) / (1 + np.exp(eps * BETA))
    if eps > 0:
        return -np.exp(-eps * (tau + BETA)) / (1 + np.exp(-eps * BETA))
    return -np.exp(-eps * tau) / (1 + np.exp(eps * BETA))


def eval_v(K):
    return 8 * np.pi / (np.dot(K, K) + MASS2)


def graph_weights(rows, varK, varT):
    """Evaluate graph rows with physical G/V; returns {response: weight}."""
    out = {}
    for row in rows:
        root = row["diagram"]
        leafmap, leafvec = {}, []
        for leaf in root.leaves():
            if leaf.id in leafmap:
                continue
            pid = leaf.properties
            k = np.asarray(pid.extK)
            K = varK[:, :len(k)] @ k
            if isinstance(pid, BareGreenId):
                val = eval_g(K, varT[pid.extT[0] - 1], varT[pid.extT[1] - 1])
            elif isinstance(pid, BareInteractionId):
                val = eval_v(K)
            else:
                raise TypeError(type(pid))
            leafmap[leaf.id] = len(leafvec)
            leafvec.append(val)
        w = eval_graph(root, leafmap, leafvec)
        out[row["response"]] = out.get(row["response"], 0.0) + w
    return out


CHANNEL_MAP = {tuple([PHr]): [T], tuple([PHEr]): [U], tuple([PPr]): [S],
               (PHr, PHEr, PPr): [T, U, S]}


@pytest.mark.parametrize("loop_num", [1, 2, 3])
@pytest.mark.parametrize("chans", [(PHr,), (PHEr,), (PPr,), (PHr, PHEr, PPr)])
def test_vertex4_vs_oracle(loop_num, chans):
    blocks = ParquetBlocks(phi=(PHEr, PPr), ppi=(PHr, PHEr))
    K0 = np.zeros(loop_num + 2)
    KinL, KoutL, KinR = K0.copy(), K0.copy(), K0.copy()
    KinL[0] = KoutL[0] = 1.0
    KinR[1] = 1.0
    KoutR = K0.copy()
    KoutR[1] = 1.0
    legK = [KinL, KoutL, KinR]

    para = DiagPara(type=Ver4Diag, isFermi=True, hasTau=True,
                    innerLoopNum=loop_num, totalLoopNum=loop_num + 2,
                    totalTauNum=loop_num + 1, spin=2, firstLoopIdx=3,
                    firstTauIdx=1, filter=(NoHartree, Girreducible),
                    transferLoop=tuple(KinL - KoutL),
                    interaction=(Interaction(ChargeCharge, Instant),))

    rng = np.random.default_rng(42 + loop_num)
    varK = rng.random((3, para.totalLoopNum))
    varT = rng.random(para.totalTauNum)

    # graph pipeline
    rows = vertex4(para, legK, channels=list(chans), blocks=blocks)
    rows = mergeby(rows, ["response"])
    w_graph = graph_weights(rows, varK, varT)

    # graph pipeline after optimization must agree
    rows_opt = mergeby(vertex4(para, legK, channels=list(chans), blocks=blocks),
                       ["response"])
    roots = [r["diagram"] for r in rows_opt]
    roots_opt = optimize(roots, level=1)
    for r, g in zip(rows_opt, roots_opt):
        r["diagram"] = g
    w_graph_opt = graph_weights(rows_opt, varK, varT)
    for resp in w_graph:
        assert w_graph_opt[resp] == pytest.approx(w_graph[resp], rel=1e-10)

    # independent oracle
    oracle_chans = CHANNEL_MAP[tuple(chans)]
    ver4 = Ver4(para, oracle_chans, F=[I, U, S], V=[I, T, U])
    legK_val = [varK[:, 0], varK[:, 0], varK[:, 1], varK[:, 1]]
    eval_ver4(para, ver4, varK, varT, legK_val, eval_g, eval_v, fast=True)
    w_oracle = ver4.weight[0]

    # UpUp = direct + exchange; UpDown = direct
    assert w_graph.get(UpUp, 0.0) == pytest.approx(w_oracle.d + w_oracle.e, rel=1e-9)
    assert w_graph.get(UpDown, 0.0) == pytest.approx(w_oracle.d, rel=1e-9)
