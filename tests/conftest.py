import os
import sys

# Run the test suite on a virtual 8-device CPU mesh so multi-device sharding
# logic is exercised without a GPU.  Must be set before importing jax.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

# jax may already be imported (and its config cached) before this file
# runs, so set the same options through jax.config as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

# GV diagram tables: use the reference data files (a data contract, not code)
# when present; self-generated tables take precedence via FD_GV_TABLES.
_REF_TABLES = "/root/reference/src/frontend/GV_diagrams"
if "FD_GV_TABLES" not in os.environ and os.path.isdir(_REF_TABLES):
    os.environ["FD_GV_TABLES"] = _REF_TABLES


@pytest.fixture(autouse=True)
def _fresh_uid():
    """Reset the graph uid counter between tests for reproducible ids."""
    from feynmandiagram.computational_graph import uid_reset
    uid_reset()
    yield
