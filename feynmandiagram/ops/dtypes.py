"""Default device dtype.

The reference is Float64-first on CPU (common.jl:3-13).  The device-side
default follows the active jax x64 config: f64 when x64 is enabled (the
CPU test meshes enable it in tests/conftest.py), f32 otherwise.  Scripts
that run on the GPU pass their dtype explicitly.
"""
from __future__ import annotations


def default_device_dtype():
    import jax
    import jax.numpy as jnp

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
