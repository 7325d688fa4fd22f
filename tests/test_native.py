"""Native graphcore kernels: build, correctness vs fallback, and the
record-level CSE in lowering."""
import random

import numpy as np
import pytest

from feynmandiagram import native
from feynmandiagram.computational_graph import Graph, SUM, PROD
from feynmandiagram.ops import lower, make_evaluator


def test_native_builds():
    assert native.native_available(), "g++ build of graphcore failed"


def test_cse_native_matches_fallback():
    rng = np.random.default_rng(0)
    n = 200
    ops = rng.integers(0, 3, n).astype(np.int8)
    powers = np.zeros(n, np.int32)
    prop = rng.integers(0, 5, n).astype(np.uint64)
    counts = np.where(ops == 0, 0, rng.integers(1, 4, n))
    counts[0] = 0
    edge_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=edge_ptr[1:])
    edge_src = np.concatenate([rng.integers(0, max(i, 1), counts[i])
                               for i in range(n)]).astype(np.int64) \
        if edge_ptr[-1] else np.zeros(0, np.int64)
    edge_fac = rng.choice([1.0, -1.0, 2.0], int(edge_ptr[-1]))

    lib = native.get_lib()
    assert lib is not None
    remap_native, n1 = native.cse(ops, powers, prop, edge_ptr, edge_src, edge_fac)
    # force the python fallback
    old = native._lib
    try:
        native._lib = None
        native._build_failed = True
        remap_py, n2 = native.cse(ops, powers, prop, edge_ptr, edge_src, edge_fac)
    finally:
        native._lib = old
        native._build_failed = False
    np.testing.assert_array_equal(remap_native, remap_py)
    assert n1 == n2


def test_depth_native_matches_fallback():
    rng = np.random.default_rng(1)
    n = 300
    counts = np.array([0 if i < 10 else rng.integers(1, 4) for i in range(n)])
    edge_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=edge_ptr[1:])
    edge_src = np.concatenate([rng.integers(0, max(i, 1), counts[i])
                               for i in range(n)]).astype(np.int64)
    d_native = native.depth(edge_ptr, edge_src)
    old = native._lib
    try:
        native._lib = None
        native._build_failed = True
        d_py = native.depth(edge_ptr, edge_src)
    finally:
        native._lib = old
        native._build_failed = False
    np.testing.assert_array_equal(d_native, d_py)


def test_lowering_cse_preserves_values_and_shrinks():
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_lowering import random_dag

    rng = random.Random(3)
    leaves = [Graph([], properties=("leaf", i)) for i in range(5)]
    # duplicated structure: same sub-dag built twice
    def dup():
        a = Graph([leaves[0], leaves[1]], subgraph_factors=[2.0, 3.0], operator=SUM)
        return Graph([a, leaves[2]], operator=PROD)
    roots = [dup(), dup()] + [random_dag(rng, leaves) for _ in range(2)]
    present = []
    for r in roots:
        for leaf in r.leaves():
            if leaf.id not in present:
                present.append(leaf.id)
    leafmap = {uid: i for i, uid in enumerate(sorted(present))}
    vals = np.asarray([rng.uniform(0.5, 1.5) for _ in range(len(leafmap))])
    base = lower(roots, leafmap, sum_mode="bucketed")
    merged = lower(roots, leafmap, sum_mode="bucketed", cse=True)
    assert merged.num_slots < base.num_slots
    out_base = np.asarray(make_evaluator(base)(vals))
    out_cse = np.asarray(make_evaluator(merged)(vals))
    np.testing.assert_allclose(out_cse, out_base, rtol=1e-12)
