"""Multi-controller bring-up for multi-host device clusters (SURVEY §5.8).

The reference is single-process; on a multi-host cluster each host process calls
``initialize_distributed`` before any jax call, then builds global meshes
with jax.devices() spanning all hosts.
"""
from __future__ import annotations

from typing import Optional


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Thin wrapper over jax.distributed.initialize (no-op when single
    process and no coordinator is configured)."""
    import jax

    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception:
            return  # single-process / unsupported environment
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
