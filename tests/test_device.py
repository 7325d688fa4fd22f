"""Device set-up: compile-cache placement, the GPU guard, matmul precision
of the leaf phase, and a platform-independent ``layout='auto'``."""
import os
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from feynmandiagram.utils import device


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_dir(monkeypatch, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache — a fixed
    path, never a temporary one."""
    if env_dir is None:
        monkeypatch.delenv(device.CACHE_ENV, raising=False)
        want = os.path.join(device.REPO_ROOT, ".jax_cache")
    else:
        monkeypatch.setenv(device.CACHE_ENV, env_dir)
        want = env_dir
    assert device.compile_cache_dir() == want
    assert device.compile_cache_dir() == want  # stable across calls
    if env_dir is None:
        assert not want.startswith(tempfile.gettempdir())
        assert os.path.isfile(os.path.join(device.REPO_ROOT, "chip_smoke.py"))


def test_enable_compile_cache_sets_jax_config(monkeypatch):
    monkeypatch.setenv(device.CACHE_ENV, "/some/cache/dir")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert device.enable_compile_cache() == "/some/cache/dir"
        assert jax.config.jax_compilation_cache_dir == "/some/cache/dir"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(device.NoGpuError, match="no GPU"):
        device.require_gpu()


def _leaf_fn(dtype=jnp.float32, layout="flat"):
    from feynmandiagram.ops.leaf_eval import LeafTables, make_leaf_evaluator

    tables = LeafTables(
        leaf_type=np.array([1, 2, 1], np.int32),
        g_order=np.zeros(3, np.int32), v_order=np.zeros(3, np.int32),
        tau_in=np.array([1, 1, 2], np.int32),
        tau_out=np.array([2, 1, 1], np.int32),
        loop_idx=np.array([0, 1, 1], np.int32),
        loop_basis=np.array([[1.0, 0.0], [1.0, -1.0]]))
    return make_leaf_evaluator(tables, beta=0.5, kF=1.0, lam=1.0, dtype=dtype,
                               layout=layout)


def test_loop_pool_matmul_runs_at_highest_precision():
    """A float32 LoopPool product must not run in TF32 on a GPU: the einsum
    carries Precision.HIGHEST in the traced program."""
    fn = _leaf_fn()
    jaxpr = jax.make_jaxpr(fn)(jnp.ones((3, 2, 128), jnp.float32),
                               jnp.ones((2, 128), jnp.float32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 1
    prec = dots[0].params["precision"]
    assert prec is not None
    assert all(p == jax.lax.Precision.HIGHEST for p in prec), prec


def _ev_jaxpr(kind):
    if kind == "leaf":
        fn = _leaf_fn(layout="auto")
        args = (jnp.ones((3, 2, 2048), jnp.float32),
                jnp.ones((2, 2048), jnp.float32))
    else:
        from feynmandiagram.computational_graph import PROD, SUM, Graph
        from feynmandiagram.ops import lower, make_evaluator

        a, b, c = (Graph([]) for _ in range(3))
        root = Graph([Graph([a, b], operator=PROD),
                      Graph([b, c], operator=PROD)], operator=SUM)
        fn = make_evaluator(lower([root], sum_mode="fused"),
                            dtype=jnp.float32, layout="auto", jit=False)
        args = (jnp.ones((3, 2048), jnp.float32),)
    return str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("kind", ["leaf", "graph"])
def test_auto_layout_ignores_platform(monkeypatch, kind):
    """layout='auto' traces the same program whatever platform JAX reports."""
    on_cpu = _ev_jaxpr(kind)
    real = jax.devices
    fake = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100", id=0)]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: fake)
    on_gpu = _ev_jaxpr(kind)
    monkeypatch.setattr(jax, "devices", real)
    assert on_gpu == on_cpu
