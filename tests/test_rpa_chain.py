"""RPA bubble-counterterm chain test (reference front_end.jl:398-443):
with all leaves == 1, the RPA chain telescopes to an analytic value."""
import numpy as np
import pytest

from feynmandiagram.computational_graph import eval_graph
from feynmandiagram.frontends import ChargeCharge, Instant, Dynamic, PHr, PHEr
from feynmandiagram.frontends.parquet import (DiagPara, Interaction, Ver4Diag,
                                                  mergeby)
from feynmandiagram.frontends.parquet.common import get_k
from feynmandiagram.frontends.parquet.vertex4 import rpa_chain


def _make_para(loopnum):
    return DiagPara(type=Ver4Diag, hasTau=True, innerLoopNum=loopnum,
                    interaction=(Interaction(ChargeCharge, [Instant, Dynamic]),))


@pytest.mark.parametrize("chan,w_upup,w_updown", [
    # each bubble contributes 2, each dynamic interaction contributes 2;
    # exchange adds a minus sign and forbids updown
    (PHEr, -1, 0.0),
    (PHr, +1, 1.0),
])
def test_rpa_chain_weights(chan, w_upup, w_updown):
    loopnum = 3
    para = _make_para(loopnum)
    legK1 = get_k(para.totalLoopNum, 1)
    legK2 = get_k(para.totalLoopNum, 2)
    legK3 = get_k(para.totalLoopNum, 3)
    extK = [legK1, legK2, legK3, legK1 + legK3 - legK2]

    ver4df = []
    rpa_chain(ver4df, para, extK, chan, 0, "RPA", -1.0)
    diags = mergeby(ver4df, ["response"])
    weight = (2 ** loopnum) * (2 ** (loopnum + 1))
    w = [eval_graph(row["diagram"]) for row in diags]
    assert w[0] == pytest.approx(w_upup * weight)
    if w_updown == 0.0:
        assert w[1] == pytest.approx(0.0)
    else:
        assert w[1] == pytest.approx(w_updown * weight)
