"""feynmandiagram — a framework for compiling and evaluating Feynman-diagram
computational graphs in batched diagrammatic Monte Carlo.

Built from scratch against the capability surface of
numericalEFT/FeynmanDiagram.jl, re-designed for batched evaluation on an
accelerator:

- Front ends (Parquet / GV) generate diagram DAGs on the host
  (``frontends``), exactly reproducing the reference's physics semantics
  (signs, symmetry factors, tau/loop slot bookkeeping).
- The graph IR (``computational_graph``) supports transforms, optimization
  passes (structural-hash CSE), and Taylor-mode AD (``taylor``/``utility``)
  for renormalization counterterms.
- The backend (``ops``/``backends``) lowers optimized DAGs to flat,
  level-scheduled CSR edge lists and evaluates batches of Monte-Carlo
  samples as fused gather-multiply-reduce ops under ``jax.jit`` on the
  device, with sample-axis and graph-axis sharding via ``jax.sharding``
  (``parallel``).
"""
import sys as _sys

# Host-side graph generation is recursive over combinatorially deep DAGs.
if _sys.getrecursionlimit() < 100000:
    _sys.setrecursionlimit(100000)

__version__ = "0.1.0"

from . import computational_graph
from . import quantum_operators
from . import taylor
from . import utility
from . import frontends
from . import models

# heavier, jax-importing layers are imported lazily on attribute access
_LAZY = {"ops", "backends", "parallel"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
