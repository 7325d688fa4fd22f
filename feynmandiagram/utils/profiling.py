"""Profiling hooks (the reference has only ad-hoc @time; SURVEY §5.1).

``trace`` wraps jax.profiler for TensorBoard-compatible device traces;
``lowered_cost`` reports the op-count cost model of a lowered graph.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler trace around a code block (default directory:
    ``$TMPDIR/fd_trace``)."""
    import os
    import tempfile

    import jax

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "fd_trace")

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def lowered_cost(lowered, batch: int = 1) -> Dict[str, float]:
    """Cost model of a LoweredGraph: edge ops, FLOPs and bytes per batch."""
    edges = lowered.num_edges
    flops = 2.0 * edges * batch
    bytes_accessed = 4.0 * (2 * edges + lowered.num_slots) * batch
    return {
        "num_slots": lowered.num_slots,
        "num_levels": lowered.num_levels,
        "num_edges": edges,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": flops / bytes_accessed,
    }
