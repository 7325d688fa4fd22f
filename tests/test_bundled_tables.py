"""The bundled self-generated tables must drive the GV front end standalone."""
import os

import pytest

from feynmandiagram.frontends import gv
from feynmandiagram.computational_graph import eval_graph

BUNDLED = os.path.join(os.path.dirname(gv.__file__), "tables")
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(BUNDLED, "groups_sigma")),
    reason="bundled tables not generated")


@pytest.fixture(autouse=True)
def _use_bundled():
    old = gv._TABLE_PATH
    gv.set_table_path(BUNDLED)
    yield
    gv.set_table_path(old) if old else gv.set_table_path(BUNDLED)


def test_sigma_tables_load():
    import math
    graphs = gv.diagsGV("sigma", 3)
    assert len(graphs) >= 1
    vals = [eval_graph(g) for g in graphs]
    assert all(math.isfinite(v) for v in vals)
    # leaf==1 evaluation of the full order-3 sigma cannot vanish
    assert any(v != 0 for v in vals)


def test_counterterm_equivalence_on_bundled():
    from feynmandiagram.taylor import set_variables
    from feynmandiagram.utility import taylorexpansion_feynman

    orders = [(2, 0, 0), (2, 0, 1), (2, 1, 0), (2, 1, 1)]
    dict_g = {}
    for o in orders:
        dict_g[o] = gv.diagsGV("sigma", *o)[0]
    diags = dict_g[(2, 0, 0)]
    set_variables("x y", orders=[2, 2])
    tvec, _ = taylorexpansion_feynman(diags, ([True, False], [False, True]))
    for order, graphs in dict_g.items():
        key = (order[1], order[2])
        for i in range(min(2, len(graphs))):
            assert eval_graph(tvec[i].coeffs[key]) == pytest.approx(
                eval_graph(graphs[i])), (order, i)


def test_counterterm_equivalence_order3_on_bundled():
    """Order-3 counterterm contract on the self-generated tables."""
    from feynmandiagram.taylor import set_variables
    from feynmandiagram.utility import taylorexpansion_feynman

    orders = [(3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1), (3, 2, 0)]
    dict_g = {}
    for o in orders:
        dict_g[o] = gv.diagsGV("sigma", *o)[0]
    diags = dict_g[(3, 0, 0)]
    set_variables("x y", orders=[3, 3])
    tvec, _ = taylorexpansion_feynman(diags, ([True, False], [False, True]))
    for order, graphs in dict_g.items():
        key = (order[1], order[2])
        for i in range(min(2, len(graphs))):
            assert eval_graph(tvec[i].coeffs[key]) == pytest.approx(
                eval_graph(graphs[i])), (order, i)


def test_vertex4I_tables_load():
    from feynmandiagram.frontends.common import Alli
    graphs = gv.diagsGV_ver4(3, channels=[Alli])
    assert len(graphs) > 0
